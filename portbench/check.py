"""What decides ``correct``: the program's outputs against the plain
reference, each number beside its limit (``portbench/limits/<cell>.json``).

Serving: for a sample of the window's finished requests drawn from the
seed, the longest among them, the reference runs once over each prompt
with its served tokens, and each served token's logit is compared with the
reference's best at its position.  ``logit_gap_max`` is the widest such
gap, in logits: 0 where every served token is the reference's greedy
choice, small where rounding flipped a near tie.

Training: the reference follows the first three steps from the same
weights and batches.  ``loss_gap`` is the largest difference of a step's
loss; ``grad_norm_gap`` the worst leaf's difference in the norm of the
first (clipped) gradient; ``change_gap`` the worst leaf's difference in
the norm of its change over the three steps.  A leaf's gap is taken
against the larger of the reference's norm of that leaf and of the median
leaf.  Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of ``change_gap``.
"""
from __future__ import annotations

import importlib
import statistics

import torch

from portbench.reference.adamw import AdamW as RefAdamW
from portbench.reference.common import Prec, tf32_off


def reference_module(model: dict):
    return importlib.import_module(f"portbench.reference.{model['arch']}")


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: [reading, limit]})."""
    out, ok = {}, True
    for name, spec in limits.items():
        val = readings.get(name)
        lim = spec["limit"]
        out[name] = [val, lim]
        if val is None or not val <= lim:
            ok = False
    return ok, out


@torch.no_grad()
def serve_gaps(w: dict, model: dict, samples: list, device,
               control: bool = False) -> dict:
    """The gaps over ``samples`` [(prompt ids, served ids)] of each served
    token below the reference's best logit, or with ``control``, of the
    token that the float8 reference puts first: the widest
    (``logit_gap_max``) and the mean over all tokens (``logit_gap_mean``)."""
    tf32_off()
    ref = reference_module(model)
    f32, fp8 = Prec("f32"), Prec("fp8")
    widest, total, count = 0.0, 0.0, 0
    for prompt, out in samples:
        seq = torch.tensor([list(prompt) + list(out[:-1])], device=device)
        x, _ = ref.hidden(w, model, seq, f32)
        lg = ref.logits(w, model, x[0, len(prompt) - 1:], f32)
        if control:
            xq, _ = ref.hidden(w, model, seq, fp8)
            tok = ref.logits(w, model, xq[0, len(prompt) - 1:], fp8).argmax(-1)
        else:
            tok = torch.tensor(list(out), device=device)
        gap = lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0]
        widest = max(widest, float(gap.max()))
        total += float(gap.sum())
        count += gap.numel()
    return {"logit_gap_max": widest, "logit_gap_mean": total / count}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |prog - ref| over max(ref, median of ref)."""
    keys = [k for k in ref if keep is None or keep(k)]
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def train_reference(w: dict, model: dict, opt: dict, batches: list,
                    prec: Prec) -> dict:
    """The reference's three steps from weights ``w`` (float32 leaves,
    updated in place): per-step losses, the first clipped gradient's norm
    a leaf, each leaf's change over the steps and its first gradient."""
    tf32_off()
    ref = reference_module(model)
    start = {k: t.detach().clone() for k, t in w.items()}
    for t in w.values():
        t.requires_grad_(True)
    adam = RefAdamW(opt, w)
    losses, g1 = [], None
    keys = list(w)
    for batch in batches:
        x, aux = ref.hidden(w, model, batch["tokens"], prec, remat=True)
        loss = _loss(ref, w, model, x, batch["targets"], prec)
        total = loss + model.get("router_aux_coef", 0.0) * aux
        grads = torch.autograd.grad(total, [w[k] for k in keys],
                                    allow_unused=True, materialize_grads=True)
        losses.append(float(loss.detach()))
        del x, aux, loss, total
        clipped = adam.step(w, dict(zip(keys, grads)))
        del grads
        if g1 is None:
            g1 = {k: float(g.norm()) for k, g in clipped.items()}
        del clipped
    change = {k: float((w[k].detach() - start[k]).norm()) for k in keys}
    return {"losses": losses, "grad_norms": g1, "change_norms": change}


def _loss(ref, w, model, x, targets, prec, rows: int = 1024):
    """Mean next-token cross entropy, the logits made ``rows`` tokens at a
    time under recomputation, so all of them are never held at once."""
    from torch.utils.checkpoint import checkpoint

    xf = x.reshape(-1, x.shape[-1])
    tf = targets.reshape(-1).long()
    total = xf.new_zeros(())

    def part(xs, ts):
        lg = ref.logits(w, model, xs, prec)
        return (torch.logsumexp(lg, -1)
                - lg.gather(-1, ts[:, None])[:, 0]).sum()

    for lo in range(0, xf.shape[0], rows):
        total = total + checkpoint(part, xf[lo:lo + rows], tf[lo:lo + rows],
                                   use_reentrant=False)
    return total / xf.shape[0]


def train_readings(prog: dict, refr: dict) -> dict:
    """The three compared numbers of a training cell."""
    med = statistics.median(refr["grad_norms"].values())
    moved = lambda k: refr["grad_norms"][k] >= 1e-3 * med
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"],
                                                   refr["losses"])),
        "grad_norm_gap": leaf_gaps(prog["grad_norms"], refr["grad_norms"]),
        "change_gap": leaf_gaps(prog["change_norms"], refr["change_norms"],
                                keep=moved),
    }
