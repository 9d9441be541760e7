"""Shared defaults — port of pathway_tpu/xpacks/llm/constants.py
(reference: xpacks/llm/constants.py)."""

DEFAULT_VISION_MODEL = "gpt-4o"
