"""Document parsers, UDFs mapping raw bytes to [(text, metadata)] chunks —
port of pathway_tpu/xpacks/llm/parsers.py (reference: xpacks/llm/parsers.py
— ParseUtf8, ParseUnstructured, ParseOpenParse).

``ParseUtf8`` is ported. ``ParseUnstructured`` and ``ParseOpenParse`` run,
in the JAX package, on its in-repo extractors (``_doc_extract.py``: PDF
content streams, DOCX/PPTX, HTML) when their libraries are absent, as
they are on the chip machine; those extractors are not ported yet, so
both raise ``NotImplementedError`` naming their ROADMAP step.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import udfs

_DOC_EXTRACT = ("ROADMAP queue 1, step 10 (item 8): the document "
                "extractors, _doc_extract.py")


def _as_text(contents: Any) -> str:
    if isinstance(contents, bytes):
        return contents.decode("utf-8", errors="replace")
    return str(contents)


class ParseUtf8(udfs.UDF):
    """Decode raw bytes as UTF-8 → one chunk (reference ParseUtf8)."""

    def __wrapped__(self, contents: Any, **kwargs) -> list[tuple[str, dict]]:
        return [(_as_text(contents), {})]


class ParseUnstructured(udfs.UDF):
    """unstructured-io parser (reference ParseUnstructured). Not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ParseUnstructured is not ported to pathway_tpu_torch yet "
            f"({_DOC_EXTRACT})")


class ParseOpenParse(udfs.UDF):
    """openparse PDF layout parser (reference ParseOpenParse). Not
    ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ParseOpenParse is not ported to pathway_tpu_torch yet "
            f"({_DOC_EXTRACT})")
