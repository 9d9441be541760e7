"""Type aliases for the llm xpack — port of pathway_tpu/xpacks/llm/_typing.py
(reference: xpacks/llm/_typing.py)."""

from typing import Callable, Iterable, TypeAlias, Union

import pathway_tpu_torch as pw

Doc: TypeAlias = dict[str, str | dict]

DocTransformerCallable: TypeAlias = Union[
    Callable[[Iterable[Doc]], Iterable[Doc]],
    Callable[[Iterable[Doc], float], Iterable[Doc]],
]

DocTransformer: TypeAlias = Union[pw.udfs.UDF, DocTransformerCallable]
