"""What the plain references share: precisions, norms, the training
steps (loss, clip, AdamW) and the served-logit gaps.

Plain PyTorch: nothing of the program is imported, and nothing the
program made is read but the outputs that are judged (served tokens,
losses, norms). The references compute in float32 with TF32 off, from the
benchmark's own weights. A ``Precision`` rounds what a product reads:
``fp32`` nothing; ``fp8``, the control, each operand of every product to
float8 e4m3 with a per-tensor scale (the step below the configurations'
bfloat16), with straight-through gradients.

A family module (such as ``dense.py``) gives ``layout(cfg)``, the
port's parameter tree, and ``hidden(params, cfg, tokens, positions,
prec, remat)``, the last hidden states (T, d) of one sequence after the
final norm; the unembedding, the loss and the gaps are here.
"""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # largest finite float8 e4m3


class Precision:
    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in fp32, rounded as a product's operand."""
        x = x.float()
        if self.name == "fp32":
            return x
        s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        r = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
        return x + (r - x).detach() if x.requires_grad else r

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ self.q(w)


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32 (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rms_norm(x, w, eps: float):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def logits(fam, params, cfg, tokens, positions, rows, prec: Precision):
    """fp32 logits of one sequence at the positions ``rows``."""
    h = fam.hidden(params, cfg, tokens, positions, prec, remat=False)
    return prec.mm(h[rows], params["embed"]["unembed"])


def row_loss(fam, params, cfg, tokens, labels, positions, prec, remat):
    """Mean next-token cross entropy of one row, in fp32."""
    h = fam.hidden(params, cfg, tokens, positions, prec, remat=remat)
    lg = prec.mm(h, params["embed"]["unembed"])
    return F.cross_entropy(lg, labels.long())


# --------------------------------------------------------------------------
# training: the port's documented step (launch/specs.make_train_step):
# the batch's mean loss, its gradient clipped to a global norm of 1, AdamW
# (fp32 moments), each update cast to the parameter's type, then added
# --------------------------------------------------------------------------

def lr_at(step: int, opt: Dict) -> float:
    """Linear warmup, then cosine decay to ``floor`` of the peak
    (``optim.warmup_cosine``, the warmup as ``launch.specs.make_optimizer``
    sets it from the total steps)."""
    total = opt["total_steps"]
    warmup = max(10, min(200, total // 10))
    peak, floor = opt["peak_lr"], opt["floor"]
    if step < warmup:
        return peak * min(step / max(warmup, 1), 1.0)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))


def train(fam, cfg, opt: Dict, params, batches: Sequence[Dict],
          prec: Precision, rows: Optional[int] = None) -> Dict[str, list]:
    """``len(batches)`` steps from ``params`` (bf16 leaves, replaced in
    place by their trained values): each step's loss, each leaf's
    gradient norm at the first step (as the optimizer gets it, after the
    clip). Rows go one at a time through a layer-by-layer recomputed
    backward (``rows`` keeps the first rows of each batch: a fault the
    comparison must catch)."""
    dev = leaves(params)[0].device
    p32 = [p.float().requires_grad_(True) for p in leaves(params)]
    tree = _rebuild(params, p32)
    m = [torch.zeros_like(p) for p in p32]
    v = [torch.zeros_like(p) for p in p32]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, grad_norms = [], None
    with exact_fp32():
        for step, batch in enumerate(batches):
            tok = torch.as_tensor(batch["tokens"], device=dev)
            lab = torch.as_tensor(batch["labels"], device=dev)
            pos = torch.as_tensor(batch["positions"], device=dev)
            n = tok.shape[0] if rows is None else rows
            total = torch.zeros((), device=dev)
            for r in range(n):
                loss = row_loss(fam, tree, cfg, tok[r], lab[r], pos[r], prec,
                                remat=True) / n
                loss.backward()
                total += loss.detach()
            losses.append(float(total))
            with torch.no_grad():
                grads = [p.grad for p in p32]
                norm = torch.sqrt(sum(g.square().sum() for g in grads))
                scale = torch.clamp(opt["clip"] / torch.clamp(norm, min=1e-9),
                                    max=1.0)
                for g in grads:
                    g.mul_(scale)
                if step == 0:
                    grad_norms = torch.stack([g.norm() for g in grads]).tolist()
                lr = lr_at(step, opt)
                bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
                for p, g, mi, vi, p16 in zip(p32, grads, m, v, leaves(params)):
                    mi.mul_(b1).add_((1 - b1) * g)
                    vi.mul_(b2).add_((1 - b2) * g.square())
                    delta = (mi / bc1) / (torch.sqrt(vi / bc2) + eps) + wd * p
                    upd = (-lr * delta).to(p16.dtype).float()
                    p.copy_((p + upd).to(p16.dtype).float())
                    p.grad = None
    with torch.no_grad():
        for p, p16 in zip(p32, leaves(params)):
            p16.copy_(p.to(p16.dtype))
    return {"losses": losses, "grad_norms": grad_norms}


def _rebuild(tree, flat: List[torch.Tensor]):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def worst_leaf(got: Sequence[float], want: Sequence[float],
               keep: Optional[Sequence[bool]] = None) -> float:
    """The largest gap between two sides' norms of a leaf, over the
    larger of the reference's norm of that leaf and of its median leaf."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = statistics.median(want[i] for i in idx)
    return max(abs(got[i] - want[i]) / max(want[i], med, 1e-30) for i in idx)


def median_leaf(got: Sequence[float], want: Sequence[float],
                keep: Optional[Sequence[bool]] = None) -> float:
    """The median leaf's gap, measured as :func:`worst_leaf` measures
    each: steady from seed to seed where the worst leaf is the rounding
    of a few small leaves."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = statistics.median(want[i] for i in idx)
    return statistics.median(abs(got[i] - want[i]) / max(want[i], med, 1e-30)
                             for i in idx)


def movable(grad_norms: Sequence[float], share: float = 1e-3) -> List[bool]:
    """The leaves whose reference gradient is not nought to rounding: at
    least ``share`` of the median leaf's (a key's bias under softmax, or a
    leaf no token reaches, moves under AdamW by round-off alone)."""
    med = statistics.median(grad_norms)
    return [g >= share * med for g in grad_norms]


# --------------------------------------------------------------------------
# serving: the gap of each served token below the reference's best logit
# --------------------------------------------------------------------------

def served_sequence(req: Dict, device):
    """The slots the server filled for one request, in order: the prompt,
    its pads (token 0) up to the batch's longest prompt ``tmax``, then the
    served tokens fed back, the t-th at RoPE position len(prompt) + t; and
    the slots whose logits chose each served token."""
    prompt, tmax, served = req["prompt"], req["tmax"], req["served"]
    n = len(prompt)
    tokens = torch.cat([torch.as_tensor(prompt, dtype=torch.long),
                        torch.zeros(tmax - n, dtype=torch.long),
                        torch.as_tensor(served[:-1], dtype=torch.long)])
    positions = torch.cat([torch.arange(tmax),
                           n + torch.arange(len(served) - 1)])
    rows = torch.tensor([n - 1] + [tmax + t for t in range(len(served) - 1)])
    return tokens.to(device), positions.to(device), rows.to(device)


def served_readings(fam, cfg, params, requests: Sequence[Dict], device,
                    control: Optional[Precision] = None) -> Dict[str, float]:
    """Over the requests' served tokens: ``max_logit_gap``, the widest gap
    between the reference's best logit and its logit of the served token
    (with ``control``, of the token that ``control`` puts first); and over
    the requests that carry the program's step logits (``logits``: one row
    a served token), ``max_logit_err``, their largest distance from the
    reference's (with ``control``, of the control's logits)."""
    exact = Precision("fp32")
    gap_max, err_max = 0.0, None
    with torch.no_grad(), exact_fp32():
        for req in requests:
            tok, pos, rows = served_sequence(req, device)
            ref = logits(fam, params, cfg, tok, pos, rows, exact)
            got = req.get("logits")
            if control is None:
                pick = torch.as_tensor(req["served"], device=device).long()
            else:
                low = logits(fam, params, cfg, tok, pos, rows, control)
                pick = low.argmax(-1)
                got = None if got is None else low
            gap = ref.max(-1).values - ref.gather(1, pick[:, None])[:, 0]
            gap_max = max(gap_max, float(gap.max()))
            if got is not None:
                err = float((got.float() - ref).abs().max())
                err_max = err if err_max is None else max(err_max, err)
            del ref
    out = {"max_logit_gap": gap_max}
    if err_max is not None:
        out["max_logit_err"] = err_max
    return out
