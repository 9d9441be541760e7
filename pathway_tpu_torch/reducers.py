"""Alias module, as pathway_tpu/reducers.py: ``import
pathway_tpu_torch.reducers`` resolves to the implementing module."""

import sys

from pathway_tpu_torch.internals import reducers_frontend as _impl

sys.modules[__name__] = _impl
