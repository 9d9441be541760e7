"""Pre-execution checks — port of pathway_tpu/internals/static_check/,
trimmed to the UDF classifier that the auto-jit tier reads
(``shard_check.classify_udf``). The analyzer itself (``pw.static_check``,
the PWT diagnostics) is not ported: ROADMAP queue 1, item 6g."""
