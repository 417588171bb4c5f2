"""The Mamba-2 language model's weights from the seed, and its plain
reference: float32 PyTorch (TF32 off), layer by layer, with autograd for
training and the reference's AdamW.

It imports nothing of the port.  The weights are made here and handed to
both sides under the port's parameter paths (``groups.p0_ssd.ssd.in_proj``
and so on, every layer stacked on the first dimension).  The equations are
Mamba-2's (arXiv:2405.21060) as the port states them in its
``models/ssd.py`` and ``models/blocks.py``: pre-norm residual blocks,
``in_proj`` to (z, x, B, C, dt) with one B / C group, a causal depthwise
conv of width 4 with SiLU over (x, B, C), dt = softplus(dt + dt_bias),
the SSD recurrence h_t = exp(dt a) h_{t-1} + B_t (dt x_t)^T, y_t = C_t h_t
+ D x_t, a gated RMSNorm over the whole inner width, then ``out_proj``;
RMSNorm before each block (every epsilon the file's ``norm_epsilon``),
and the head tied to the embedding where the file ties them.
The SSD runs as the chunked algorithm (exact in exact arithmetic) at the
configuration's chunk.

``precision="fp8"`` is the control: every matrix product computed as float8
training computes it (operands in e4m3, gradients in e5m2, one scale a
tensor), the nearest precision below the bfloat16 the configuration
computes in.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

LAYERS = ("groups", "p0_ssd")
UPDATE_SLICE = 1 << 24  # elements of a leaf updated at a time


@dataclass(frozen=True)
class Dims:
    d: int
    layers: int
    vocab: int
    di: int
    heads: int
    p: int
    n: int
    conv: int
    chunk: int
    tied: bool
    eps: float

    @property
    def proj(self) -> int:
        return 2 * self.di + 2 * self.n + self.heads

    @property
    def conv_dim(self) -> int:
        return self.di + 2 * self.n


def model_vocab(m: Dict) -> int:
    """The rows of the embedding: the tokenizer's vocabulary padded to the
    source's ``pad_vocab_size_multiple``."""
    k = int(m.get("pad_vocab_size_multiple", 1))
    return -(-int(m["vocab_size"]) // k) * k


def dims(m: Dict) -> Dims:
    di = m["expand"] * m["d_model"]
    return Dims(d=m["d_model"], layers=m["n_layer"], vocab=model_vocab(m), di=di,
                heads=di // m["headdim"], p=m["headdim"], n=m["d_state"], conv=m["d_conv"],
                chunk=m["chunk_size"], tied=bool(m["tie_embeddings"]),
                eps=float(m["norm_epsilon"]))


def padded_vocab(v: int) -> int:
    return -(-v // 8) * 8


# -- weights -------------------------------------------------------------------

def leaf_specs(dm: Dims) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """(path, shape, init) of every leaf, in a fixed order; ``matrix``
    marks the leaves the port serves in its compute type."""
    L, V = dm.layers, padded_vocab(dm.vocab)
    s = LAYERS + ("ssd",)
    head = [] if dm.tied else [(("embed", "head"), (dm.d, V), "normal:0.02:matrix")]
    return [(("embed", "tok"), (1, V, dm.d), "normal:0.02:matrix")] + head + [
        (("final_norm", "scale"), (dm.d,), "ones"),
        (LAYERS + ("norm1", "scale"), (L, dm.d), "ones"),
        (s + ("in_proj",), (L, dm.d, dm.proj), f"normal:{dm.d ** -0.5}:matrix"),
        (s + ("conv_w",), (L, dm.conv, dm.conv_dim), f"uniform:{dm.conv ** -0.5}"),
        (s + ("conv_b",), (L, dm.conv_dim), f"uniform:{dm.conv ** -0.5}"),
        (s + ("a_log",), (L, dm.heads), "a_log"),
        (s + ("dt_bias",), (L, dm.heads), "dt_bias"),
        (s + ("d_skip",), (L, dm.heads), "ones"),
        (s + ("norm_scale",), (L, dm.di), "ones"),
        (s + ("out_proj",), (L, dm.di, dm.d),
         f"normal:{dm.di ** -0.5 / math.sqrt(dm.layers)}:matrix"),
    ]


def make_leaf(spec, index: int, seed: int, device) -> torch.Tensor:
    """One leaf in float32 from its own generator (seed, leaf index), so any
    leaf can be made again alone; one draw a leaf."""
    _, shape, init = spec
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + 7_919 * (index + 1)) % (1 << 63))
    kind = init.split(":")
    if kind[0] == "ones":
        return torch.ones(shape, device=device)
    if kind[0] == "normal":
        return torch.randn(shape, generator=gen, device=device).mul_(float(kind[1]))
    if kind[0] == "uniform":
        b = float(kind[1])
        return torch.rand(shape, generator=gen, device=device).mul_(2 * b).sub_(b)
    u = torch.rand(shape, generator=gen, device=device)
    if kind[0] == "a_log":  # A uniform on [1, 16]
        return torch.log(1 + 15 * u)
    if kind[0] == "dt_bias":  # dt log-uniform on [1e-3, 1e-1], through softplus's inverse
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {init!r}")


def make_weights(m: Dict, seed: int, device, serve_dtype=None) -> Dict[Tuple[str, ...], torch.Tensor]:
    """Every leaf, float32; with ``serve_dtype`` the matrices in that type
    (as the port serves them)."""
    out = {}
    for i, spec in enumerate(leaf_specs(dims(m))):
        t = make_leaf(spec, i, seed, device)
        if serve_dtype is not None and spec[2].endswith(":matrix"):
            t = t.to(serve_dtype)
        out[spec[0]] = t
    return out


def as_tree(flat: Dict[Tuple[str, ...], torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


# -- the model -----------------------------------------------------------------

def _fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to a float8 type with one scale for the tensor (no
    gradient: ``_FP8Matmul`` owns the backward)."""
    x = x.detach()
    s = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / s).to(dtype).to(torch.float32) * s


class _FP8Matmul(torch.autograd.Function):
    """a @ b as float8 training computes it: both operands rounded to e4m3
    in the forward; the incoming gradient rounded to e5m2 and multiplied by
    the rounded operands in the backward."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _FP8Matmul.apply(a, b)
    return a @ b


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def ssd_chunked(xdt, log_a, b, c, chunk: int):
    """y (S, H, P) of h_t = exp(log_a_t) h_{t-1} + b_t xdt_t^T, y_t = c_t h_t,
    h_0 = 0: xdt (S, H, P), log_a (S, H), b and c (S, N), float32."""
    S, H, P = xdt.shape
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = xdt.shape[0] // L
    x = xdt.reshape(nc, L, H, P)
    la = log_a.reshape(nc, L, H)
    bb = b.reshape(nc, L, -1)
    cc = c.reshape(nc, L, -1)
    cum = torch.cumsum(la, 1)  # (nc, L, H)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    seg = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(~causal[None, :, :, None],
                                                                 -math.inf)
    cb = torch.einsum("cln,csn->cls", cc, bb)
    y = torch.einsum("cls,clsh,cshp->clhp", cb, torch.exp(seg), x)
    # each chunk's state from its own inputs, then carried chunk to chunk
    tail = torch.exp(cum[:, -1:, :] - cum)  # (nc, L, H)
    states = torch.einsum("cln,clh,clhp->chnp", bb, tail, x)
    total = torch.exp(cum[:, -1, :])  # (nc, H)
    h = torch.zeros_like(states[0])
    h_in = []
    for k in range(nc):
        h_in.append(h)
        h = total[k][:, None, None] * h + states[k]
    h_in = torch.stack(h_in)  # (nc, H, N, P)
    y = y + torch.einsum("cln,clh,chnp->clhp", cc, torch.exp(cum), h_in)
    return y.reshape(nc * L, H, P)[:S]


def block(w: Dict[str, torch.Tensor], x: torch.Tensor, dm: Dims, precision: str) -> torch.Tensor:
    """One pre-norm residual Mamba-2 block on x (S, d), float32."""
    S = x.shape[0]
    proj = matmul(rms(x, w["norm1"], dm.eps), w["in_proj"], precision)
    z, xs, bm, cm, dt_raw = torch.split(proj, [dm.di, dm.di, dm.n, dm.n, dm.heads], -1)
    conv_in = F.pad(torch.cat([xs, bm, cm], -1), (0, 0, dm.conv - 1, 0))
    conv = sum(conv_in[i:i + S] * w["conv_w"][i] for i in range(dm.conv))
    xs, bm, cm = torch.split(F.silu(conv + w["conv_b"]), [dm.di, dm.n, dm.n], -1)
    dt = F.softplus(dt_raw + w["dt_bias"])
    log_a = dt * -torch.exp(w["a_log"])
    xh = xs.reshape(S, dm.heads, dm.p)
    y = ssd_chunked(xh * dt[..., None], log_a, bm, cm, dm.chunk)
    y = (y + w["d_skip"][:, None] * xh).reshape(S, dm.di)
    y = rms(y * F.silu(z), w["norm_scale"], dm.eps)
    return x + matmul(y, w["out_proj"], precision)


def _layer(weights, i: int) -> Dict[str, torch.Tensor]:
    s = LAYERS + ("ssd",)
    out = {k: weights[s + (k,)][i] for k in ("in_proj", "conv_w", "conv_b", "a_log", "dt_bias",
                                             "d_skip", "norm_scale", "out_proj")}
    out["norm1"] = weights[LAYERS + ("norm1", "scale")][i]
    return out


def hidden(weights, tokens: torch.Tensor, dm: Dims, precision: str, remat: bool = False):
    """The final normed hidden states (S, d) of one sequence."""
    x = weights[("embed", "tok")][0][tokens.long()]
    for i in range(dm.layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda x, i=i: block(_layer(weights, i), x, dm, precision), x,
                use_reentrant=False)
        else:
            x = block(_layer(weights, i), x, dm, precision)
    return rms(x, weights[("final_norm", "scale")], dm.eps)


def head(weights, dm: Dims) -> torch.Tensor:
    """The output projection (d, V): the embedding's transpose where tied."""
    return weights[("embed", "tok")][0].t() if dm.tied else weights[("embed", "head")]


def logits_at(weights, tokens: torch.Tensor, positions: Sequence[int], dm: Dims,
              precision: str = "float32") -> torch.Tensor:
    """The logits (len(positions), vocab) of one sequence at ``positions``,
    without autograd."""
    with torch.no_grad(), tf32_off():
        h = hidden(weights, tokens, dm, precision)
        idx = torch.as_tensor(list(positions), device=h.device)
        out = matmul(h[idx], head(weights, dm), precision)
    return out[:, : dm.vocab]


def loss(weights, tokens, labels, dm: Dims, precision: str) -> torch.Tensor:
    h = hidden(weights, tokens, dm, precision, remat=True)
    lg = matmul(h, head(weights, dm), precision)[:, : dm.vocab]
    return F.cross_entropy(lg, labels.long())


class tf32_off:
    """TF32 off for float32 products while inside (restored after)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


# -- training ------------------------------------------------------------------

def lr_at(opt: Dict, step: int) -> float:
    """Linear warmup, then cosine decay to min_lr_frac (the port's schedule)."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def train_readings(m: Dict, seed: int, batches, opt: Dict, device, precision: str = "float32"):
    """Three AdamW steps from the seed's weights on ``batches`` (each
    (tokens, labels) of one sequence) → (losses, {path: |g| of step 1 as the
    optimizer gets it, clipped}, {path: |p3 - p0|})."""
    dm = dims(m)
    weights = {k: v.requires_grad_() for k, v in make_weights(m, seed, device).items()}
    mu = {k: torch.zeros_like(v) for k, v in weights.items()}
    nu = {k: torch.zeros_like(v) for k, v in weights.items()}
    losses, g1 = [], {}
    b1, b2 = opt["b1"], opt["b2"]
    with tf32_off():
        for step, (tokens, labels) in enumerate(batches, start=1):
            lv = loss(weights, tokens, labels, dm, precision)
            grads = dict(zip(weights, torch.autograd.grad(lv, list(weights.values()))))
            losses.append(float(lv.detach()))
            gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2
                                  for g in grads.values()))
            clip = min(opt["grad_clip"] / max(gnorm, 1e-12), 1.0)
            lr = lr_at(opt, step)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            with torch.no_grad():
                for k in list(grads):
                    g = grads.pop(k).mul_(clip)
                    if step == 1:
                        g1[k] = float(torch.linalg.vector_norm(g))
                    p = weights[k]
                    flat = (p.view(-1), g.view(-1), mu[k].view(-1), nu[k].view(-1))
                    for a in range(0, flat[0].numel(), UPDATE_SLICE):
                        ps, gs, ms, vs = (t[a:a + UPDATE_SLICE] for t in flat)
                        ms.mul_(b1).add_(gs, alpha=1 - b1)
                        vs.mul_(b2).addcmul_(gs, gs, value=1 - b2)
                        if p.dim() >= 2:
                            ps.mul_(1 - lr * opt["weight_decay"])
                        ps.sub_(lr * (ms / bc1) / (torch.sqrt(vs / bc2) + opt["eps"]))
                    del g
    change = {}
    with torch.no_grad():
        for i, spec in enumerate(leaf_specs(dm)):
            change[spec[0]] = float((weights[spec[0]] - make_leaf(spec, i, seed, device)).norm())
    return losses, g1, change
