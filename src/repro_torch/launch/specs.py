"""Stand-ins for every model input of one (architecture x assigned shape)
cell, laid out on a mesh (the port's counterpart of ``repro.launch.specs``).

The reference returns ``jax.ShapeDtypeStruct``s with shardings attached.
Here each input is a tensor made with ``torch.empty`` on ``device``, and
under a ``MeshInfo`` a DTensor laid out by its logical axes (``None`` gives
plain tensors).  Call these under ``FakeTensorMode`` (the dry run does):
then nothing is allocated, and each rank's DTensor holds a fake shard of
its real local shape.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import MeshInfo
from repro_torch.models import LanguageModel
from repro_torch.models.layers import torch_dtype
from repro_torch.utils import tree_map


def _input(info: MeshInfo | None, shape: Sequence[int], dtype: torch.dtype,
           axes: Sequence[str | None], device) -> torch.Tensor:
    x = torch.empty(tuple(shape), dtype=dtype, device=device)
    return x if info is None else info.distribute(x, tuple(axes))


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, info: MeshInfo | None,
                device="cpu") -> dict[str, torch.Tensor]:
    """Training and prefill batch inputs."""
    b, s = shape.global_batch, shape.seq_len
    bs = ("batch", "seq_act")
    specs = {"tokens": _input(info, (b, s), torch.int32, bs, device)}
    if shape.kind == "train":
        specs["targets"] = _input(info, (b, s), torch.int32, bs, device)
        specs["weights"] = _input(info, (b, s), torch.float32, bs, device)
    if cfg.enc_dec:  # audio frontend stub: precomputed frame embeddings
        specs["frames"] = _input(info, (b, s, cfg.d_model), torch.float32,
                                 ("batch", "seq_act", None), device)
    if cfg.pos_type == "mrope":  # vision frontend stub: M-RoPE coordinates
        specs["positions"] = _input(info, (3, b, s), torch.int32,
                                    (None, "batch", "seq_act"), device)
    return specs


def cache_input_specs(model: LanguageModel, shape: ShapeSpec,
                      info: MeshInfo | None, dtype=torch.bfloat16,
                      device="cpu") -> Any:
    specs = model.cache_specs(shape.global_batch, shape.seq_len,
                              enc_len=shape.seq_len, dtype=dtype)
    return tree_map(lambda sp: _input(info, sp.shape, sp.dtype, sp.axes,
                                      device), specs)


def decode_token_specs(cfg: ModelConfig, shape: ShapeSpec,
                       info: MeshInfo | None,
                       device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    b = shape.global_batch
    tokens = _input(info, (b, 1), torch.int32, ("batch", None), device)
    pos = _input(info, (b,), torch.int32, ("batch",), device)
    return tokens, pos


def param_specs(model: LanguageModel, info: MeshInfo | None,
                dtype: str | None = None, device="cpu") -> Any:
    """Parameters of ``model``'s shapes and dtypes (from its meta-device
    init), laid out by ``param_axes``.  ``dtype`` recasts the matrices;
    norms and other vectors keep their dtype, as the reference's do."""
    meta = LanguageModel(model.cfg, device="meta").init()
    to = None if dtype is None else torch_dtype(dtype)

    def make(t: torch.Tensor, axes) -> torch.Tensor:
        dt = t.dtype if to is None or t.ndim <= 1 else to
        return _input(info, t.shape, dt, axes, device)

    return tree_map(make, meta, model.param_axes)

