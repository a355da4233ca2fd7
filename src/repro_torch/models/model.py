"""LanguageModel: init / train_loss / prefill / prefill_chunk / decode_step
for the decoder-only attention (standard or MLA, dense or MoE), RG-LRU
hybrid, RWKV-6, encoder-decoder (whisper: a sinusoidal-position encoder,
learned decoder positions, cross-attention) and M-RoPE (qwen2-vl: 3-stream
positions, precomputed ``embeds``) architectures (port of
``repro.models.model``).

Parameters are a nested dict of tensors keyed exactly as the JAX pytree
(scanned segments keep their leading ``layers`` axis), so
``repro_torch.bridge`` carries weights across leaf for leaf.  Caches are
nested dicts too, updated in place: each serving call returns the cache it
was given.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, replicate
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import ModelCtx
from repro_torch.models.layers import (Param, apply_norm, embed_init,
                                       init_norm, sinusoidal_positions, split,
                                       torch_dtype)
from repro_torch.utils import Spec, tree_map

#: matrices that JAX reads in f32 at every use, never in the compute dtype:
#: RWKV-6's bonus ``u`` and decay projection ``decay_B``
#: (``repro/models/recurrent.py:328, 336``), RG-LRU's conv weights
#: ``conv_w`` (``recurrent.py:104, 128, 132``) and the MoE router
#: (``repro/models/moe.py:70``)
F32_AT_USE = frozenset({"u", "decay_B", "conv_w", "router"})


class LanguageModel:
    def __init__(self, cfg: ModelConfig, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dec_kinds = tfm.layer_kinds(cfg, decoder=cfg.enc_dec)
        self.dec_segments = tfm.plan_segments(cfg, self.dec_kinds)
        self.enc_segments = []
        if cfg.enc_dec:
            self.enc_segments = tfm.plan_segments(
                cfg, [("attn", False)] * cfg.n_enc_layers)
        self._axes: dict | None = None

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> dict:
        """Weights on ``self.device`` from one seeded generator (the numbers
        differ from ``jax.random``'s; tests bridge JAX weights instead).
        Records the logical axes of every leaf (``param_axes``)."""
        gen = None
        if self.device.type != "meta":
            gen = torch.Generator(device=self.device).manual_seed(seed)
        cfg, dev = self.cfg, self.device
        tree: dict[str, Any] = {
            "embed": Param(embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                      cfg.param_dtype, device=dev),
                           ("vocab", "embed_fsdp"))}
        if not cfg.tie_embeddings:
            tree["out"] = Param(embed_init(gen, (cfg.d_model, cfg.vocab_size),
                                           cfg.param_dtype, device=dev),
                                ("embed_fsdp", "vocab"))
        if cfg.pos_type == "learned":
            tree["pos_embed"] = Param(embed_init(
                gen, (cfg.max_positions, cfg.d_model), cfg.param_dtype,
                device=dev), (None, "embed_fsdp"))
        if cfg.embed_norm:
            tree["embed_ln"] = init_norm(cfg, cfg.d_model, device=dev)
        params, axes = split(tree)
        for i, seg in enumerate(self.dec_segments):
            params[f"seg{i}"], axes[f"seg{i}"] = tfm.init_segment(
                gen, cfg, seg, device=dev)
        params["final_norm"], axes["final_norm"] = split(
            init_norm(cfg, cfg.d_model, device=dev))
        if cfg.enc_dec:
            enc, enc_axes = {}, {}
            for i, seg in enumerate(self.enc_segments):
                enc[f"seg{i}"], enc_axes[f"seg{i}"] = tfm.init_segment(
                    gen, cfg, seg, device=dev)
            enc["final_norm"], enc_axes["final_norm"] = split(
                init_norm(cfg, cfg.d_model, device=dev))
            params["enc"], axes["enc"] = enc, enc_axes
        self._axes = axes
        return params

    @property
    def param_axes(self) -> dict:
        """The logical axes of every parameter leaf, a tree of tuples keyed as
        the parameters (``repro/models/model.py:85``): a scanned segment's
        leaves start with ``"layers"``.  Computed on the meta device if
        ``init`` has not run."""
        if self._axes is None:
            meta = LanguageModel(self.cfg, device="meta")
            meta.init()
            self._axes = meta._axes
        return self._axes

    def param_shapes(self) -> dict:
        """Shape tree of ``init``'s output, computed on the meta device."""
        meta = LanguageModel(self.cfg, device="meta")
        return tree_map(lambda t: tuple(t.shape), meta.init())

    def cast_for_compute(self, params: dict) -> dict:
        """One compute-dtype copy, made once at load time, of every weight
        that JAX casts to the compute dtype at each use in serving
        (``attention.py:401-469``, ``layers.py:174-180``): the matrices, i.e.
        leaves of rank >= 2 per layer (the leading ``layers`` axis of a
        scanned segment does not count), except ``F32_AT_USE``.  Vectors stay
        as they are: JAX reads norm scales, ``w0`` and the group-norm
        weights in f32, and casts the token-shift mixes at use, as the port
        does.  Casting a weight once gives the bits that casting it at every
        use gives, so no number changes, and the f32 masters (10 GB for
        gemma-2b) are not re-read on every step.  The vectors and
        ``F32_AT_USE`` leaves of the copy are the masters' own tensors.
        The encoder's segments (``params["enc"]``) are walked as the
        decoder's: a scanned segment's stacked norm vectors stay f32."""
        cdt = torch_dtype(self.cfg.compute_dtype)

        def walk(node: Any, name: str, lead: int) -> Any:
            if isinstance(node, dict):
                return {k: walk(v, k, lead) for k, v in node.items()}
            if (node.is_floating_point() and node.ndim - lead >= 2
                    and name not in F32_AT_USE):
                return node.to(cdt)
            return node

        def top(tree: dict, segments: list) -> dict:
            scanned = {f"seg{i}" for i, seg in enumerate(segments)
                       if seg.scanned}
            return {k: top(v, self.enc_segments) if k == "enc"
                    else walk(v, k, int(k in scanned))
                    for k, v in tree.items()}

        return top(params, self.dec_segments)

    def cast_for_train(self, params: dict) -> dict:
        """The compute-dtype weights ``train_loss`` reads: JAX's
        ``_cast_for_compute`` (``repro/models/model.py:140-155``) exactly.
        Every float leaf whose *stored* rank is >= 2 goes to the compute
        dtype, so in a scanned segment the stacked vectors (norm scales
        ``(L, d)``, ``w0``, ``ln_w``, ``mu_*``; the encoder's too) are read
        in bf16, and so are ``u`` and ``decay_B`` -- unlike serving
        (``cast_for_compute``).
        Nothing is cast when the compute dtype is the parameter dtype.  The
        casts are differentiable: gradients reach the f32 masters through
        them."""
        cdt = torch_dtype(self.cfg.compute_dtype)
        if cdt == torch_dtype(self.cfg.param_dtype):
            return params
        return tree_map(lambda t: t.to(cdt) if (t.is_floating_point()
                                                and t.ndim >= 2) else t,
                        params)

    # ------------------------------------------------------------- embeddings
    def _embed(self, params: dict, tokens: torch.Tensor,
               embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Token embeddings, or ``embeds`` (B, S, d) from a modality
        frontend (the stub's precomputed patch embeddings) in their place."""
        cfg = self.cfg
        cdt = torch_dtype(cfg.compute_dtype)
        if embeds is not None:
            x = embeds.to(cdt)
        else:
            # a lookup, not indexing: DTensor shards embedding's backward
            # (torch 2.11's index_put rule fails on a sharded index)
            x = F.embedding(tokens.long(), params["embed"]).to(cdt)
        if cfg.emb_scale:
            x = x * math.sqrt(cfg.d_model)
        if cfg.embed_norm:
            x = apply_norm(params["embed_ln"], cfg, x)
        return constrain(x, "batch", "seq_act", None)

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(params["final_norm"], cfg, x)
        w = params["embed"].T if cfg.tie_embeddings else params["out"]
        logits = (x @ w.to(torch_dtype(cfg.compute_dtype))).float()
        return constrain(logits, "batch", "seq_act", "vocab")

    def _positions(self, batch_size: int, seq: int,
                   given: torch.Tensor | None) -> torch.Tensor:
        """``given``, or 0..seq-1 in every row: (B, S), or three equal
        streams (3, B, S) for M-RoPE; replicated over the mesh if one is
        active."""
        if given is not None:
            return replicate(given)
        pos = replicate(torch.arange(seq, dtype=torch.int32, device=self.device))
        if self.cfg.pos_type == "mrope":
            return pos.expand(3, batch_size, seq)
        return pos.expand(batch_size, seq)

    def _add_positions(self, params: dict, x: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
        """The learned position table's rows (whisper's decoder), added in
        x's dtype; other position types act inside attention."""
        if self.cfg.pos_type != "learned":
            return x
        return x + params["pos_embed"][pos.long()].to(x.dtype)

    def _frames(self, batch: dict) -> torch.Tensor:
        if "frames" not in batch:  # the reference fails with a KeyError
            raise ValueError(
                f"{self.cfg.name} is an encoder-decoder model: its calls need "
                "batch['frames'], the (B, S_enc, d_model) frame embeddings "
                "of its audio frontend")
        return batch["frames"]

    # --------------------------------------------------------------- encoder
    def _encode(self, params: dict, frames: torch.Tensor,
                contiguous: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """The encoder over ``frames`` (``repro/models/model.py:125-136``):
        sinusoids added in the compute dtype, non-causal self-attention,
        the encoder's final norm.  Returns (enc_out, enc_positions).
        ``contiguous`` is the caller's: a full prefill (positions not given)
        runs the encoder's attention through the flash kernel; training
        (which needs the gradient) and chunked prefill run it plain."""
        cfg = self.cfg
        B, S, _ = frames.shape
        x = frames.to(torch_dtype(cfg.compute_dtype))
        x = x + replicate(sinusoidal_positions(S, cfg.d_model, x.dtype,
                                               x.device))[None]
        x = constrain(x, "batch", "seq_act", None)
        pos = self._positions(B, S, None)
        ctx = ModelCtx(mode="encode", positions=pos, causal=False,
                       contiguous=contiguous)
        for i, seg in enumerate(self.enc_segments):
            x, _, _ = tfm.apply_segment(params["enc"][f"seg{i}"], cfg, seg, x,
                                        None, ctx)
        return apply_norm(params["enc"]["final_norm"], cfg, x), pos

    def _ctx(self, params: dict, batch: dict, contiguous: bool,
             **kw) -> ModelCtx:
        """The context of one call, with the encoder's output when the
        model has one."""
        if self.cfg.enc_dec:
            kw["enc_out"], kw["enc_positions"] = self._encode(
                params, self._frames(batch), contiguous)
        return ModelCtx(contiguous=contiguous, **kw)

    def _backbone(self, params: dict, x: torch.Tensor, caches: Any,
                  ctx: ModelCtx) -> tuple[torch.Tensor, Any, Any]:
        """(x, caches, the router loss summed over the MoE layers: 0.0, a
        float, in a model without experts)."""
        aux = 0.0
        for i, seg in enumerate(self.dec_segments):
            c = None if caches is None else caches[f"seg{i}"]
            x, _, a = tfm.apply_segment(params[f"seg{i}"], self.cfg, seg, x,
                                        c, ctx)
            aux = aux + a
        return x, caches, aux

    # ------------------------------------------------------------------ train
    def train_loss(self, params: dict,
                   batch: dict) -> tuple[torch.Tensor, dict]:
        """Mean next-token loss of ``batch`` (``tokens``, ``targets``: (B, S)
        int; optional ``weights`` (B, S) f32 and ``positions``), as JAX's
        ``train_loss`` (``repro/models/model.py:171-200``).  The label logit
        is a ``gather``, not JAX's one-hot product (the same number: a
        (B, S, vocab) f32 one-hot would take 2 GB at gemma-2b's width).
        Attention runs the plain ``attention_core``, RWKV-6 the chunked
        form and RG-LRU its doubling scan: neither kernel has a backward,
        in JAX or here.  ``aux_loss`` is the MoE router loss summed over the
        layers (0 without experts), and the total is
        ``loss + router_aux_coef * aux_loss`` (JAX ``model.py:159-200``).
        An encoder-decoder model reads ``frames``; ``embeds`` replace the
        token embeddings (M-RoPE's ``positions`` are then (3, B, S))."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        weights = batch.get("weights")
        if weights is None:
            weights = replicate(torch.ones(B, S, dtype=torch.float32,
                                           device=tokens.device))
        params = self.cast_for_train(params)
        pos = self._positions(B, S, batch.get("positions"))
        ctx = self._ctx(params, batch, False, mode="train", positions=pos)
        x = self._embed(params, tokens, batch.get("embeds"))
        x = self._add_positions(params, x, pos)
        x, _, aux = self._backbone(params, x, None, ctx)
        logits = self._head(params, x)

        lse = torch.logsumexp(logits, dim=-1)
        label_logit = logits.gather(-1, batch["targets"].long()[..., None])[..., 0]
        nll = (lse - label_logit) * weights
        denom = constrain(torch.clamp(weights.sum(), min=1.0))
        loss = constrain(nll.sum() / denom)  # replicated under a mesh
        if not isinstance(aux, torch.Tensor):  # no MoE layer: the float 0.0
            aux = replicate(torch.tensor(aux, dtype=torch.float32,
                                         device=loss.device))
        total = loss + cfg.router_aux_coef * aux
        metrics = {"loss": loss, "aux_loss": aux, "tokens": denom,
                   "total_loss": total}
        return total, metrics

    # ------------------------------------------------------------------ serve
    def cache_specs(self, batch: int, max_len: int, enc_len: int = 0,
                    dtype=torch.bfloat16,
                    pages: tuple[int, int] | None = None) -> dict:
        """``pages=(n_pages, page_size)`` swaps full-attention KV caches for
        shared page pools (no batch dim; see launch/paged_kv.py).  Cross
        caches hold ``enc_len or max_len`` frames, as in JAX."""
        return {f"seg{i}": tfm.segment_cache_specs(
                    self.cfg, seg, batch, max_len, enc_len or max_len, dtype,
                    pages=pages)
                for i, seg in enumerate(self.dec_segments)}

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0,
                   dtype=torch.bfloat16,
                   pages: tuple[int, int] | None = None) -> dict:
        def make(spec: Spec) -> torch.Tensor:
            if spec.dtype == torch.int32:  # slot-position arrays start empty
                return torch.full(spec.shape, -1, dtype=spec.dtype,
                                  device=self.device)
            return torch.zeros(spec.shape, dtype=spec.dtype, device=self.device)

        return tree_map(make, self.cache_specs(batch, max_len, enc_len, dtype,
                                               pages=pages))

    def prefill(self, params: dict, batch: dict,
                cache: dict) -> tuple[torch.Tensor, dict]:
        """batch["tokens"]: (B, S); ``frames`` for an encoder-decoder model,
        optional ``embeds`` (B, S, d) and ``positions``.  Without
        ``batch["positions"]`` the positions are 0..S-1 and attention runs
        through the flash kernel: the decoder's self-attention, and for an
        encoder-decoder model the encoder's and the cross-attention too."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        given = batch.get("positions")
        pos = self._positions(B, S, given)
        ctx = self._ctx(params, batch, given is None, mode="prefill",
                        positions=pos)
        x = self._embed(params, tokens, batch.get("embeds"))
        x = self._add_positions(params, x, pos)
        x, cache, _ = self._backbone(params, x, cache, ctx)
        return self._head(params, x[:, -1:])[:, 0], cache

    def prefill_chunk(self, params: dict, batch: dict, cache: dict,
                      start: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Continue prefilling an existing cache with one chunk of tokens.

        batch["tokens"]: (B, C); start: (B,) absolute position of the chunk's
        first token.  Attends over (cache contents + chunk), so calling this
        over an exact partition of the prompt equals one full ``prefill``.
        Returns the last-position logits and the updated cache."""
        tokens = batch["tokens"]
        B, C = tokens.shape
        pos = (start[:, None].to(torch.int32)
               + torch.arange(C, dtype=torch.int32, device=tokens.device))
        if self.cfg.pos_type == "mrope":
            pos = pos.expand(3, B, C)
        ctx = self._ctx(params, batch, False, mode="chunk_prefill",
                        positions=pos)
        x = self._embed(params, tokens, batch.get("embeds"))
        x = self._add_positions(params, x, pos)
        x, cache, _ = self._backbone(params, x, cache, ctx)
        return self._head(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict,
                    pos: torch.Tensor,
                    table: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        """tokens: (B, 1); pos: (B,) current positions (0-based, -1 =
        inactive slot).  ``table`` is the (B, max_pages) block table when
        ``cache`` holds paged pools."""
        B = tokens.shape[0]
        positions = pos[:, None].to(torch.int32)
        if self.cfg.pos_type == "mrope":
            positions = positions.expand(3, B, 1)
        ctx = ModelCtx(mode="decode", positions=positions, cache_pos=pos,
                       table=table)
        x = self._embed(params, tokens)
        x = self._add_positions(params, x, positions)
        x, cache, _ = self._backbone(params, x, cache, ctx)
        return self._head(params, x)[:, 0], cache
