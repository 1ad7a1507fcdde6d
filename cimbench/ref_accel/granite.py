"""Granite-4.0-H (``granitemoehybrid``) in plain float32 ``torch``: the
forward pass, the loss, the gradients and one AdamW first moment, for the
accel kind's check.  It imports nothing of the program.

The equations are those of the published model (Hugging Face
``modeling_granitemoehybrid.py`` for ibm-granite/granite-4.0-h-small):

* ``x = embed[tokens] * embedding_multiplier``; each layer
  ``x += mixer(rmsnorm(x)) * residual_multiplier`` with the mixer of its
  ``layer_types`` entry, then ``x += (moe(h) + shared(h)) *
  residual_multiplier`` with ``h = rmsnorm(x)``; ``logits =
  rmsnorm(x) @ embed.T / logits_scaling`` (tied embeddings).
* Mamba-2: ``in_proj`` to [z, x|B|C, dt]; a depthwise causal conv with
  bias over x|B|C, SiLU; ``dt = softplus(dt + dt_bias)``, ``A =
  -exp(A_log)``; the SSD of the Mamba-2 paper (arXiv:2405.21060, its
  minimal listing, ``ssd`` below) over ``x dt``, ``A dt``, B, C; ``+ D x``;
  a gated RMSNorm ``rmsnorm(y silu(z))``; ``out_proj``.
* Attention: GQA, no position embedding, scores scaled by
  ``attention_multiplier``, causal softmax.
* Mixture of experts: top-k over the router's logits, softmax over those
  k; each held expert ``silu(h Wg) * (h Wu) Wd`` weighted by its gate;
  the shared expert alike, unweighted.

Departures, each noted where it is made:

* Norm weights are stored as offsets from one (``(1 + w)``), the
  program's layout; the published checkpoint stores ``1 + w``.  The same
  function of the same numbers.
* The router's weight is float32 (the program keeps routers in float32).
* The load-balancing loss is the Switch-style loss at coefficient 0.01
  (config.json gives none; the configuration lists it under ``assumed``).
* Expert share: the layer holds only ``experts_held`` of the router's
  experts and adds only their part; what the others would add is left
  out, as in the program.
* Routing: where ``routes`` are given (the program's choice of experts
  per token and layer), the reference uses them, and :func:`route_gap`
  measures how far they are from a top-k of its own float32 logits.  A
  one-ulp difference before a router flips near-tied choices, and one
  flipped token moves an expert's gradient by far more than rounding, so
  the gradients can only be compared under one routing.

Weights and tokens are drawn as the program draws them (:func:`draw`):
every random leaf ``randn(shape) / sqrt(fan_in)`` (the embedding
``* 0.02``) from one generator seeded with the unit's seed, in the
program's parameter order, rounded to its dtype; then the tokens and the
labels, uniform over the vocabulary.  On the card the gradients are taken
one layer at a time, each layer's forward recomputed from its stored
input (:func:`step`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: coefficient of the load-balancing loss, Adam's beta1 and the
#: gradient-norm clip of the program's TrainConfig defaults
AUX_COEF = 0.01
BETA1 = 0.9
CLIP = 1.0
#: query rows per block of the reference's attention
ATTN_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class Spec:
    """The shapes and constants of a configuration file (catalog keys)."""
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    pattern: Tuple[str, ...]
    ssm_heads: int
    ssm_head_dim: int
    d_state: int
    chunk: int
    d_conv: int
    router_experts: int
    held: Tuple[int, ...]
    top_k: int
    expert_ff: int
    shared_ff: int
    emb_mult: float
    res_mult: float
    logits_scaling: float
    attn_mult: float
    eps: float
    #: the parameters' dtype (the program's bfloat16, or float32)
    dtype: str = "bfloat16"

    @classmethod
    def of(cls, cfg: Dict) -> "Spec":
        if cfg["mamba_n_groups"] != 1:
            raise NotImplementedError("one group of B and C")
        n = cfg["num_hidden_layers"]
        return cls(
            d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
            n_kv_heads=cfg["num_key_value_heads"],
            head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
            vocab=cfg["vocab_size"], pattern=tuple(cfg["layer_types"][:n]),
            ssm_heads=cfg["mamba_n_heads"], ssm_head_dim=cfg["mamba_d_head"],
            d_state=cfg["mamba_d_state"], chunk=cfg["mamba_chunk_size"],
            d_conv=cfg["mamba_d_conv"],
            router_experts=cfg["published"]["num_local_experts"],
            held=tuple(cfg["experts_held"]),
            top_k=cfg["num_experts_per_tok"],
            expert_ff=cfg["intermediate_size"],
            shared_ff=cfg["shared_intermediate_size"],
            emb_mult=float(cfg["embedding_multiplier"]),
            res_mult=float(cfg["residual_multiplier"]),
            logits_scaling=float(cfg["logits_scaling"]),
            attn_mult=float(cfg["attention_multiplier"]),
            eps=float(cfg["rms_norm_eps"]), dtype=cfg["dtype"])

    @property
    def ssm_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    @property
    def conv_channels(self) -> int:
        return self.ssm_inner + 2 * self.d_state

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // 128) * 128


# ------------------------------------------------------------ the draw
def layout(spec: Spec) -> List[Tuple[str, tuple, str, object]]:
    """(path, shape, dtype, how) of every parameter in the program's
    order; ``how`` is a fan-in (``randn / sqrt(fan_in)``), ``"embed"``
    (``randn * 0.02``) or a float32 numpy array (a constant)."""
    d, s, dt = spec.d_model, spec, spec.dtype
    H, di, cc = s.ssm_heads, s.ssm_inner, s.conv_channels
    zeros = lambda n: np.zeros(n, np.float32)  # noqa: E731
    out = [("embed", (s.padded_vocab, d), dt, "embed"),
           ("final_norm/w", (d,), dt, zeros(d))]
    for i, kind in enumerate(s.pattern):
        p = f"layers/{i:02d}"
        out.append((f"{p}/norm/w", (d,), dt, zeros(d)))
        if kind == "mamba":
            dt_bias = np.log(np.expm1(np.linspace(1e-3, 0.1, H)))
            out += [
                (f"{p}/mixer/in_proj", (d, di + cc + H), dt, d),
                (f"{p}/mixer/conv_w", (s.d_conv, cc), dt, s.d_conv),
                (f"{p}/mixer/conv_b", (cc,), dt, s.d_conv),
                (f"{p}/mixer/dt_bias", (H,), "float32",
                 dt_bias.astype(np.float32)),
                (f"{p}/mixer/A_log", (H,), "float32",
                 np.log(np.arange(1.0, H + 1.0)).astype(np.float32)),
                (f"{p}/mixer/D", (H,), "float32", np.ones(H, np.float32)),
                (f"{p}/mixer/norm", (di,), dt, zeros(di)),
                (f"{p}/mixer/out_proj", (di, d), dt, di)]
        else:
            h, hk, dh = s.n_heads, s.n_kv_heads, s.head_dim
            out += [(f"{p}/mixer/wq", (d, h, dh), dt, d),
                    (f"{p}/mixer/wk", (d, hk, dh), dt, d),
                    (f"{p}/mixer/wv", (d, hk, dh), dt, d),
                    (f"{p}/mixer/wo", (h, dh, d), dt, h * dh)]
        n, f, fs = len(s.held), s.expert_ff, s.shared_ff
        out += [
            (f"{p}/ffn_norm/w", (d,), dt, zeros(d)),
            (f"{p}/ffn/router", (d, s.router_experts), "float32", d),
            (f"{p}/ffn/w_gate", (n, d, f), dt, d),
            (f"{p}/ffn/w_up", (n, d, f), dt, d),
            (f"{p}/ffn/w_down", (n, f, d), dt, f),
            (f"{p}/ffn/shared/w_gate", (d, fs), dt, d),
            (f"{p}/ffn/shared/w_up", (d, fs), dt, d),
            (f"{p}/ffn/shared/w_down", (fs, d), dt, fs)]
    return out


def draw(spec: Spec, seed: int, batch: int, seq_len: int, device
         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """The parameters (float32 tensors of the values the program holds,
    rounded to its dtypes), the tokens and the labels of a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {}
    for path, shape, dtype, how in layout(spec):
        if isinstance(how, np.ndarray):
            t = torch.from_numpy(how).to(device).expand(shape)
        else:
            scale = 0.02 if how == "embed" else 1.0 / math.sqrt(how)
            t = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * scale
        params[path] = t.to(getattr(torch, dtype)).float().contiguous()
    ints = dict(generator=gen, dtype=torch.int32, device=device)
    tokens = torch.randint(0, spec.vocab, (batch, seq_len), **ints)
    labels = torch.randint(0, spec.vocab, (batch, seq_len), **ints)
    return params, tokens.long(), labels.long()


# ------------------------------------------------------------ numerics
def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 in the forward pass (the gradient
    passes as if it were not): the control's matmul inputs."""
    return t + (t.to(torch.float8_e4m3fn).float() - t).detach()


class Numerics:
    """Where the reference rounds: ``rnd`` is applied to both inputs of
    every matrix product (:func:`exact` for the reference itself)."""

    def __init__(self, rnd: Callable = exact):
        self.rnd = rnd

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.rnd(a), self.rnd(b))


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


# ------------------------------------------------------------ Mamba-2
def segsum(x: torch.Tensor) -> torch.Tensor:
    """The paper's stable segment sum: out[..., i, j] = sum(x[..., j+1:i+1])
    for j <= i, -inf above the diagonal."""
    T = x.size(-1)
    x = x[..., None].expand(*x.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~low, 0)
    out = torch.cumsum(x, dim=-2)
    on = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), 0)
    return out.masked_fill(~on, -torch.inf)


def ssd(X, A, B, C, block: int, num: Numerics):
    """The minimal SSD of the Mamba-2 paper for one group of B and C.
    X (b, l, h, p), A (b, l, h) the log decays, B, C (b, l, n); the state
    starts at zero.  Returns Y (b, l, h, p)."""
    b, l, h, p = X.shape
    pad = (-l) % block
    if pad:
        X = F.pad(X, (0, 0, 0, 0, 0, pad))
        A = F.pad(A, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    c, n = X.shape[1] // block, B.shape[-1]
    X = X.reshape(b, c, block, h, p)
    A = A.reshape(b, c, block, h).permute(0, 3, 1, 2)         # b h c l
    B = B.reshape(b, c, block, n)
    C = C.reshape(b, c, block, n)
    A_cumsum = torch.cumsum(A, dim=-1)
    # 1. the diagonal blocks: within each chunk
    L = torch.exp(segsum(A))                                  # b h c l s
    CB = num.mm(C, B.transpose(-1, -2))                       # b c l s
    W = CB[:, None] * L                                       # b h c l s
    Xh = X.permute(0, 3, 1, 2, 4)                             # b h c s p
    Y_diag = num.mm(W, Xh).permute(0, 2, 3, 1, 4)             # b c l h p
    # 2. each chunk's final state
    decay = torch.exp(A_cumsum[..., -1:] - A_cumsum)          # b h c l
    Xd = Xh * decay[..., None]                                # b h c l p
    states = num.mm(Xd.transpose(-1, -2), B[:, None])         # b h c p n
    # 3. the recurrence over the chunks
    states = torch.cat([torch.zeros_like(states[:, :, :1]), states], dim=2)
    decay_chunk = torch.exp(segsum(F.pad(A_cumsum[..., -1], (1, 0))))
    new = torch.einsum("bhzc,bhcpn->bhzpn", decay_chunk, states)
    states = new[:, :, :-1]                                   # b h c p n
    # 4. each chunk's output from its initial state
    Y_off = num.mm(C[:, None], states.transpose(-1, -2))      # b h c l p
    Y_off = Y_off * torch.exp(A_cumsum)[..., None]
    Y = Y_diag + Y_off.permute(0, 2, 3, 1, 4)
    return Y.reshape(b, c * block, h, p)[:, :l]


def ssd_recurrence(X, A, B, C):
    """The same map token by token: h_t = exp(A_t) h_{t-1} + x_t B_t,
    y_t = C_t . h_t (the tests' second reference)."""
    b, l, h, p = X.shape
    state = X.new_zeros(b, h, p, B.shape[-1])
    ys = []
    for t in range(l):
        state = torch.exp(A[:, t])[..., None, None] * state \
            + X[:, t, :, :, None] * B[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    return torch.stack(ys, dim=1)


def mamba2(p: Dict[str, torch.Tensor], x, spec: Spec, num: Numerics,
           scan: Callable = None):
    """The published mixer over (b, l, d) from a zero state."""
    b, l, d = x.shape
    H, P, N = spec.ssm_heads, spec.ssm_head_dim, spec.d_state
    di, cc = spec.ssm_inner, spec.conv_channels
    zxbcdt = num.mm(x, p["in_proj"])
    z, xbc, dt = zxbcdt.split([di, cc, H], dim=-1)
    w = p["conv_w"].T[:, None, :]                             # (cc, 1, K)
    xbc = F.silu(F.conv1d(xbc.transpose(1, 2), w, p["conv_b"],
                          padding=spec.d_conv - 1, groups=cc)[..., :l]
                 .transpose(1, 2))
    xs, Bm, Cm = xbc.split([di, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                        # (b, l, H)
    A = -torch.exp(p["A_log"])
    X = xs.reshape(b, l, H, P)
    if scan is None:
        Y = ssd(X * dt[..., None], A * dt, Bm, Cm, spec.chunk, num)
    else:
        Y = scan(X * dt[..., None], A * dt, Bm, Cm)
    y = (Y + p["D"][:, None] * X).reshape(b, l, di)
    y = rmsnorm(y * F.silu(z), p["norm"], spec.eps)           # gated norm
    return num.mm(y, p["out_proj"])


# ------------------------------------------------------------ attention
def attention(p: Dict[str, torch.Tensor], x, spec: Spec, num: Numerics):
    """Causal GQA without position embedding, scores scaled by
    ``attention_multiplier``, in blocks of query rows."""
    b, l, d = x.shape
    h, hk, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = num.mm(x, p["wq"].reshape(d, h * dh)).reshape(b, l, h, dh)
    k = num.mm(x, p["wk"].reshape(d, hk * dh)).reshape(b, l, hk, dh)
    v = num.mm(x, p["wv"].reshape(d, hk * dh)).reshape(b, l, hk, dh)
    k = k.repeat_interleave(h // hk, dim=2).transpose(1, 2)   # b h l dh
    v = v.repeat_interleave(h // hk, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for s0 in range(0, l, ATTN_BLOCK):
        s1 = min(s0 + ATTN_BLOCK, l)
        s = num.mm(q[:, :, s0:s1], k[:, :, :s1].transpose(-1, -2))
        s = s * spec.attn_mult
        qpos = torch.arange(s0, s1, device=x.device)[:, None]
        kpos = torch.arange(s1, device=x.device)[None, :]
        s = s.masked_fill(kpos > qpos, -torch.inf)
        outs.append(num.mm(torch.softmax(s, dim=-1), v[:, :, :s1]))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, l, h * dh)
    return num.mm(o, p["wo"].reshape(h * dh, d))


# ------------------------------------------------------------ experts
def top_k_ids(logits: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(logits, k, dim=-1).indices


def route_gap(logits: torch.Tensor, route: torch.Tensor) -> float:
    """How far ``route`` (T, k) is from a top-k of ``logits`` (T, E): the
    largest excess of an expert left out over one chosen, in units of the
    logits' RMS (0 where every choice is a top-k); 1e9 where a token
    chooses one expert twice."""
    if (route.sort(-1).values.diff(dim=-1) == 0).any():
        return 1e9
    chosen = torch.zeros_like(logits, dtype=torch.bool).scatter_(
        1, route, True)
    low = logits.masked_fill(~chosen, torch.inf).amin(-1)
    high = logits.masked_fill(chosen, -torch.inf).amax(-1)
    rms = logits.square().mean().sqrt()
    return float(torch.clamp_min(high - low, 0).max() / rms)


def swiglu(h, wg, wu, wd, num: Numerics):
    return num.mm(F.silu(num.mm(h, wg)) * num.mm(h, wu), wd)


def moe(p: Dict[str, torch.Tensor], x, spec: Spec, num: Numerics,
        route: Optional[torch.Tensor] = None):
    """The held experts' part and the shared expert over (b, l, d); the
    routing ``route`` (T, k) where given, else a top-k of the logits.
    Returns (y, aux, logits, route)."""
    b, l, d = x.shape
    xf = x.reshape(b * l, d)
    logits = num.mm(xf, p["router"])                          # (T, E)
    if route is None:
        route = top_k_ids(logits.detach(), spec.top_k)
    gates = torch.softmax(logits.gather(1, route), dim=-1)
    y = torch.zeros_like(xf)
    for j, e in enumerate(spec.held):
        hit = route == e
        rows = hit.any(1).nonzero().squeeze(1)
        g = (gates * hit).sum(1)[rows]
        out = swiglu(xf[rows], p["w_gate"][j], p["w_up"][j], p["w_down"][j],
                     num)
        y = y.index_add(0, rows, out * g[:, None])
    y = y + swiglu(xf, p["shared/w_gate"], p["shared/w_up"],
                   p["shared/w_down"], num)
    E = spec.router_experts
    me = torch.softmax(logits, dim=-1).mean(0)
    ce = torch.bincount(route.reshape(-1), minlength=E).float() / route.numel()
    return y.reshape(b, l, d), E * (me * ce).sum(), logits, route


# ------------------------------------------------------------ the model
def layer_paths(params: Dict[str, torch.Tensor], i: int) -> Dict[str, str]:
    """Layer ``i``'s parameters: each one's path below ``mixer/`` or
    ``ffn/`` (``norm/w`` and ``ffn_norm/w`` as they are) -> its path."""
    pre = f"layers/{i:02d}/"
    out = {}
    for path in params:
        if path.startswith(pre):
            rest = path[len(pre):]
            for part in ("mixer/", "ffn/"):
                if rest.startswith(part):
                    rest = rest[len(part):]
            out[rest] = path
    return out


def layer_params(params: Dict[str, torch.Tensor], i: int
                 ) -> Dict[str, torch.Tensor]:
    return {k: params[v] for k, v in layer_paths(params, i).items()}


def layer(lp: Dict[str, torch.Tensor], x, kind: str, spec: Spec,
          num: Numerics, route=None, scan=None):
    """One layer; returns (x, aux, router logits, route)."""
    h = rmsnorm(x, lp["norm/w"], spec.eps)
    m = (mamba2(lp, h, spec, num, scan) if kind == "mamba"
         else attention(lp, h, spec, num))
    x = x + m * spec.res_mult
    f, aux, logits, route = moe(lp, rmsnorm(x, lp["ffn_norm/w"], spec.eps),
                                spec, num, route)
    return x + f * spec.res_mult, aux, logits, route


def head_loss(embed, final_w, x, labels, spec: Spec, num: Numerics):
    """Mean cross-entropy of the tied head's logits over the vocabulary."""
    logits = num.mm(rmsnorm(x, final_w, spec.eps), embed.T)
    logits = logits / spec.logits_scaling
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def forward_loss(params, tokens, labels, spec: Spec, num: Numerics = None,
                 routes: Optional[Dict[int, torch.Tensor]] = None,
                 scan=None):
    """(loss, aux) with autograd through everything (small sizes)."""
    num = num or Numerics()
    x = params["embed"][tokens] * spec.emb_mult
    aux = x.new_zeros(())
    for i, kind in enumerate(spec.pattern):
        x, a, _, _ = layer(layer_params(params, i), x, kind, spec, num,
                           None if routes is None else routes[i], scan)
        aux = aux + a
    return head_loss(params["embed"], params["final_norm/w"], x, labels,
                     spec, num), aux


@dataclasses.dataclass
class StepResult:
    loss: float
    aux: float
    grad_norm: float
    route_gap: float
    #: path -> (1 - beta1) * clipped gradient at the sampled indices
    m: Dict[str, torch.Tensor]
    #: rows sent to held experts, per layer
    held_rows: List[int]
    #: the choice of experts the step used, per layer, (T, k) on the host
    routes: Dict[int, torch.Tensor]


def step(params: Dict[str, torch.Tensor], tokens, labels, spec: Spec,
         sample: Dict[str, torch.Tensor], num: Numerics = None,
         routes: Optional[Dict[int, torch.Tensor]] = None) -> StepResult:
    """The loss, ``loss + 0.01 aux``'s gradients one layer at a time (each
    layer's forward recomputed from its stored input), their global norm,
    the clip, and AdamW's first moment after one step from zero at the
    flat indices ``sample[path]``.  ``routes``: the program's choice of
    experts per layer, (T, k) each."""
    num = num or Numerics()
    xs, gaps, held_rows, used = [], [], [], []
    with torch.no_grad():
        x = params["embed"][tokens] * spec.emb_mult
        for i, kind in enumerate(spec.pattern):
            xs.append(x)
            route = None if routes is None else routes[i].to(x.device)
            x, _, logits, route = layer(layer_params(params, i), x, kind,
                                        spec, num, route)
            used.append(route)
            gaps.append(route_gap(logits, route))
            held_rows.append(int(torch.isin(
                route, torch.tensor(spec.held, device=route.device)).sum()))
    sq = torch.zeros((), dtype=torch.float64, device=x.device)
    picked: Dict[str, torch.Tensor] = {}

    def take(path, g):
        nonlocal sq
        sq = sq + g.double().square().sum()
        if path in sample:
            picked[path] = g.reshape(-1)[sample[path].to(g.device)]

    embed = params["embed"].clone().requires_grad_(True)
    final_w = params["final_norm/w"].clone().requires_grad_(True)
    xl = x.clone().requires_grad_(True)
    loss = head_loss(embed, final_w, xl, labels, spec, num)
    g_x, g_embed, g_final = torch.autograd.grad(loss, [xl, embed, final_w])
    take("final_norm/w", g_final)
    aux_total = 0.0
    coef = torch.tensor(AUX_COEF, device=x.device)
    for i in reversed(range(len(spec.pattern))):
        paths = layer_paths(params, i)
        keys = sorted(paths)
        lp = {k: params[paths[k]].clone().requires_grad_(True) for k in keys}
        xi = xs[i].clone().requires_grad_(True)
        out, aux, _, _ = layer(lp, xi, spec.pattern[i], spec, num, used[i])
        aux_total += float(aux.detach())
        grads = torch.autograd.grad([out, aux], [xi] + [lp[k] for k in keys],
                                    grad_outputs=[g_x, coef])
        g_x = grads[0]
        for k, g in zip(keys, grads[1:]):
            take(paths[k], g)
        del grads, out, lp
    g_embed = g_embed.index_add(0, tokens.reshape(-1),
                                g_x.reshape(-1, g_x.shape[-1]) * spec.emb_mult)
    take("embed", g_embed)
    gn = float(sq.sqrt())
    scale = min(1.0, CLIP / max(gn, 1e-9))
    m = {k: (1 - BETA1) * v * scale for k, v in picked.items()}
    return StepResult(loss=float(loss.detach()), aux=aux_total, grad_norm=gn,
                      route_gap=max(gaps), m=m, held_rows=held_rows,
                      routes={i: r.cpu() for i, r in enumerate(used)})
