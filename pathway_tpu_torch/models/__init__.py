"""pathway_tpu_torch.models — port of pathway_tpu.models: the encoder
(BGE-small's shape by default, an optional mixture-of-experts MLP, its
tensor-parallel partition specs), its contrastive training step (on one
device, or sharded over a mesh), the CLIP dual encoder and the
tokenizers."""

from pathway_tpu_torch.models.clip import (
    ClipConfig,
    ClipModel,
    clip_train_step,
    encode_image,
    encode_text,
    init_clip_params,
)
from pathway_tpu_torch.models.encoder import (
    Encoder,
    EncoderConfig,
    encode,
    init_params_host,
    param_pspecs,
)
from pathway_tpu_torch.models.tokenizer import HashTokenizer
from pathway_tpu_torch.models.train import (
    contrastive_train_step,
    init_train_state,
    train_state_pspecs,
)

__all__ = [
    "ClipConfig",
    "ClipModel",
    "Encoder",
    "EncoderConfig",
    "clip_train_step",
    "encode",
    "encode_image",
    "encode_text",
    "init_clip_params",
    "init_params_host",
    "param_pspecs",
    "HashTokenizer",
    "contrastive_train_step",
    "init_train_state",
    "train_state_pspecs",
]
