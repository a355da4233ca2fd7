"""The plain reference against the program at the program's smoke widths on
the CPU, both in float32: the full prefill's logits, and the training
loss, router loss and gradients."""
import json

import pytest

torch = pytest.importorskip("torch")

from portbench import check  # noqa: E402
from portbench.reference.common import Prec  # noqa: E402
from portbench.weights import make_weights, nest  # noqa: E402
from conftest import DATA  # noqa: E402

CONFIGS = ("granite-smoke", "rwkv6-smoke")


def _port(cfg):
    from repro_torch.configs import get_config
    from repro_torch.models import LanguageModel

    c = get_config(cfg["port"]["name"]).scaled(**cfg["port"]["set"],
                                                compute_dtype="float32")
    return LanguageModel(c, device="cpu")


def _weights(cfg, model, seed):
    from repro_torch.utils import tree_flatten

    shapes = dict(tree_flatten(model.param_shapes()))
    return make_weights(shapes, cfg["init"], seed, torch.device("cpu"),
                        layered=frozenset(cfg["layered"]))


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_logits_match_the_program_in_f32(name):
    cfg = json.loads((DATA / "configs" / f"{name}.json").read_text())
    model = _port(cfg)
    w = _weights(cfg, model, 11)
    tokens = torch.randint(0, cfg["model"]["vocab_size"], (2, 37),
                           generator=torch.Generator().manual_seed(3))
    cache = model.init_cache(2, 64, dtype=torch.float32)
    logits, _ = model.prefill(nest(w), {"tokens": tokens.int()}, cache)
    ref = check.reference_module(cfg["model"])
    x, _ = ref.hidden(w, cfg["model"], tokens, Prec("f32"))
    want = ref.logits(w, cfg["model"], x[:, -1], Prec("f32"))
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_loss_and_gradients_match_the_program_in_f32(name):
    cfg = json.loads((DATA / "configs" / f"{name}.json").read_text())
    model = _port(cfg)
    w = _weights(cfg, model, 12)
    tokens = torch.randint(0, cfg["model"]["vocab_size"], (2, 33),
                           generator=torch.Generator().manual_seed(4))
    batch = {"tokens": tokens[:, :-1].int(), "targets": tokens[:, 1:].int()}
    leaves = {k: t.clone().requires_grad_(True) for k, t in w.items()}
    total, metrics = model.train_loss(nest(leaves), batch)
    got = torch.autograd.grad(total, list(leaves.values()))

    ref = check.reference_module(cfg["model"])
    rw = {k: t.clone().requires_grad_(True) for k, t in w.items()}
    x, aux = ref.hidden(rw, cfg["model"], batch["tokens"], Prec("f32"),
                        remat=True)
    loss = check._loss(ref, rw, cfg["model"], x, batch["targets"], Prec("f32"))
    want_total = loss + cfg["model"].get("router_aux_coef", 0.0) * aux
    want = torch.autograd.grad(want_total, list(rw.values()))
    torch.testing.assert_close(metrics["loss"], loss.detach(), atol=1e-5, rtol=1e-5)
    for k, a, b in zip(leaves, got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=k)


def test_reference_adamw_follows_the_program():
    from repro_torch.optim.adamw import AdamW, OptConfig

    from portbench.reference.adamw import AdamW as RefAdamW

    opt = {"peak_lr": 1e-2, "min_lr_ratio": 0.1, "warmup_steps": 2,
           "decay_steps": 10, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "grad_clip": 1.0}
    g = torch.Generator().manual_seed(5)
    p0 = {"a": torch.randn(4, 3, generator=g), "b": torch.randn(5, generator=g)}
    grads = [{k: torch.randn(t.shape, generator=g) for k, t in p0.items()}
             for _ in range(4)]
    mine = {k: t.clone() for k, t in p0.items()}
    ref = RefAdamW(opt, mine)
    prog = {k: t.clone() for k, t in p0.items()}
    padam = AdamW(OptConfig(**opt))
    state = padam.init(prog)
    for gs in grads:
        ref.step(mine, {k: t.clone() for k, t in gs.items()})
        prog, state, _ = padam.update({k: t.clone() for k, t in gs.items()},
                                      state, prog)
    for k in p0:
        torch.testing.assert_close(prog[k], mine[k], atol=1e-6, rtol=1e-5)


def test_wkv_chunks_equal_the_step_recurrence():
    from portbench.reference import rwkv6

    g = torch.Generator().manual_seed(6)
    S, H, N = 77, 2, 8
    r, k, v = (torch.randn(S, H, N, generator=g) for _ in range(3))
    log_w = -torch.exp(torch.rand(S, H, N, generator=g) * 6 - 6)
    u = torch.randn(H, N, generator=g) * 0.1
    state = torch.zeros(H, N, N)
    ys = []
    for t in range(S):
        kv = k[t, :, :, None] * v[t, :, None, :]
        ys.append(torch.einsum("hn,hnm->hm", r[t], state + u[:, :, None] * kv))
        state = torch.exp(log_w[t])[:, :, None] * state + kv
    torch.testing.assert_close(rwkv6.wkv(r, k, v, log_w, u), torch.stack(ys),
                               atol=1e-5, rtol=1e-5)
