"""Port counterpart of the same-named pathway_tpu subpackage."""
