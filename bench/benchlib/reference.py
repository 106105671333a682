"""The plain reference: the benchmark's decoder LMs in float32 PyTorch.

It states the models as the configuration files give them, independent of
the program (it imports nothing of it, nor JAX): RMSNorm; GQA attention
with rotary embeddings (half-split, theta ``rope_theta``) and a causal
sliding window; a top-k MoE FFN (SwiGLU experts) whose router is float32,
picks the k largest logits (a stable sort: the lower index first among
equals) and weights them by a softmax over those k, with GShard capacity
per row (``int(S * k * capacity_factor / E)`` pairs an expert, the top-1
picks of every position claiming before any top-2 pick, the rest dropped);
the Switch load-balancing loss; a Mamba-2 mixer (in-projection, depthwise
causal conv and SiLU, the SSD recurrence h_t = exp(dt_t A) h_{t-1} +
dt_t x_t B_t^T, y_t = C_t h_t + D x_t, the gated RMSNorm, out-projection);
the token-mean cross-entropy; AdamW.

Every product runs in float32 with TF32 off.  Parameters are float32 copies
of the served weights; AdamW keeps its moments in float32 and stores each
leaf back in the dtype the configuration states (a bf16 leaf is rounded to
bf16 after each update, as a bf16 model without master weights is).

``lowp`` names a precision below float32 to which every product's
operands are rounded forward, and their gradients backward.  ``"int8"`` is
the control, the step below bf16 (symmetric, one scale a tensor).  The
calibration (``bench/calibrate.py``) also reads ``"fp8"`` (e4m3 forward,
e5m2 backward, one scale a tensor) and ``"bf16"`` (the program's own
precision: what rounding alone does to the numbers compared).

This module is also the architecture module of the configurations whose
``reference`` key names it (``spec.architecture`` loads it by that path):
the dense, MoE and SSM decoders, one sub-layer a unit.  An architecture
module states what differs by architecture, and nothing else:

- ``leaves(cfg)``: the leaf list, in the port's tree layout;
- ``mixers(cfg)``: the number of sub-layers of each mixer kind,
  ``{"attn": n, "mamba": n}``;
- ``port_config(cfg)``: the port's configuration object;
- ``Model``: the float32 reference's model, ``Model(cfg, lowp)``.

The harness works out the rest alike for every architecture
(``spec.Architecture``): the reference's walks, ``train_readings_on`` and
``serve_logits_on``, run the module's ``Model`` on its leaves, and the
model-level counts are ``counts``' arithmetic on its leaves and mixers.
Another architecture's module builds on the pieces here: a subclass of
``Model`` whose blocks it overrides where its architecture differs (the
blocks run whatever sub-layers a unit holds), and
``weights.sublayer_leaves``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchlib import traffic, weights

QUERY_BLOCK = 512
CE_ROWS = 4096


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale that maps its largest
    magnitude to ``top``, and scaled back, in float32."""
    s = x.abs().amax().clamp(min=1e-30) / top
    if dtype is torch.int8:
        return (x / s).round().clamp(-top, top) * s
    return (x / s).to(dtype).to(torch.float32) * s


class _FP8(torch.autograd.Function):
    """The operand in e4m3 forward, its gradient in e5m2 backward (the
    usual fp8 training recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class _INT8(torch.autograd.Function):
    """The operand in int8 forward, its gradient in int8 backward
    (symmetric, round to nearest)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.int8, 127.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.int8, 127.0)


class _BF16(torch.autograd.Function):
    """The operand in bf16 forward, its gradient in bf16 backward."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(torch.float32)


LOWP = {"fp8": _FP8.apply, "int8": _INT8.apply, "bf16": _BF16.apply}


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


class Model:
    def __init__(self, cfg: dict, lowp: str | None = None):
        self.cfg = cfg
        self.q = LOWP[lowp] if lowp else _same
        self.eps = cfg["norm_eps"]
        self.margins = None     # a list: each MoE call's router margins

    def mm(self, a, w):
        return self.q(a) @ self.q(w)

    # ---------------------------------------------------------- attention
    def _rotary(self, x, pos):
        half = x.shape[-1] // 2
        freqs = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(half, dtype=torch.float32, device=x.device) / half))
        ang = pos.float()[:, None] * freqs
        cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    @staticmethod
    def _block(q, k, v, q0: int, k0: int, window: int):
        B, Sq, H, hd = q.shape
        KV = k.shape[2]
        qg = q.reshape(B, Sq, KV, H // KV, hd)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(hd)
        qi = torch.arange(Sq, device=q.device)[:, None] + q0
        kj = torch.arange(k.shape[1], device=q.device)[None, :] + k0
        mask = kj <= qi
        if window:
            mask &= kj > qi - window
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        return torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(B, Sq, H, hd)

    def attention(self, p, x):
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        window = cfg.get("sliding_window", 0)
        pos = torch.arange(S, device=x.device)
        q = self._rotary(self.mm(x, p["wq"]).reshape(B, S, H, hd), pos)
        k = self._rotary(self.mm(x, p["wk"]).reshape(B, S, KV, hd), pos)
        v = self.mm(x, p["wv"]).reshape(B, S, KV, hd)
        q, k, v = self.q(q), self.q(k), self.q(v)
        outs = []
        for q0 in range(0, S, QUERY_BLOCK):
            q1 = min(q0 + QUERY_BLOCK, S)
            k0 = max(0, q0 - window + 1) if window else 0
            args = (q[:, q0:q1], k[:, k0:q1], v[:, k0:q1], q0, k0, window)
            outs.append(checkpoint(self._block, *args, use_reentrant=False)
                        if torch.is_grad_enabled() else self._block(*args))
        return self.mm(torch.cat(outs, 1).reshape(B, S, H * hd), p["wo"])

    # --------------------------------------------------------------- MoE
    def _expert(self, x, wg, wu, wd):
        return self.mm(F.silu(self.mm(x, wg)) * self.mm(x, wu), wd)

    def moe(self, p, x, cap_len: int):
        """x [B, S, D] -> (y, router logits); the first ``cap_len``
        positions of each row share the experts' capacity (a prefill or a
        train row), each later position is a group of its own (a decode
        step: k distinct experts, nothing dropped)."""
        cfg = self.cfg
        B, S, D = x.shape
        E, k = cfg["n_experts"], cfg["experts_per_token"]
        logits = x @ p["router"]
        vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        probs, top = torch.softmax(vals[..., :k], -1), idx[..., :k]
        if self.margins is not None and k < E:
            self.margins.append((vals[..., k - 1] - vals[..., k]).detach())
        keep = torch.ones(B, S, k, dtype=torch.bool, device=x.device)
        if cap_len:
            C = max(int(cap_len * k * cfg["capacity_factor"] / E), 1)
            e_cm = top[:, :cap_len].transpose(1, 2).reshape(B, k * cap_len)
            oh = F.one_hot(e_cm, E)
            before = (oh.cumsum(1) - oh).gather(2, e_cm[..., None])[..., 0]
            keep[:, :cap_len] = (before < C).reshape(B, k, cap_len).transpose(
                1, 2)
        xf = x.reshape(B * S, D)
        topf, pf, kf = top.reshape(-1, k), probs.reshape(-1, k), keep.reshape(
            -1, k)
        y = torch.zeros_like(xf)
        for e in range(E):
            rows, slot = torch.nonzero((topf == e) & kf, as_tuple=True)
            if rows.numel() == 0:
                continue
            args = (xf[rows], p["w_gate"][e], p["w_up"][e], p["w_down"][e])
            h = (checkpoint(self._expert, *args, use_reentrant=False)
                 if torch.is_grad_enabled() else self._expert(*args))
            y = y.index_add(0, rows, h * pf[rows, slot, None])
        return y.reshape(B, S, D), logits

    def aux_loss(self, logits):
        E = self.cfg["n_experts"]
        probs = torch.softmax(logits, -1)
        f = F.one_hot(logits.argmax(-1), E).float().mean((0, 1))
        return E * (f * probs.mean((0, 1))).sum()

    def mlp(self, p, x):
        return self._expert(x, p["w_gate"], p["w_up"], p["w_down"])

    # ------------------------------------------------------------ Mamba-2
    def ssd(self, x, dt, A, Bm, Cm):
        """x [B, S, H, P], dt [B, S, H], A [H], Bm/Cm [B, S, N] -> y: the
        recurrence above (y_t without the D skip), computed a chunk at a
        time: within a chunk as the decayed products of C B^T, between
        chunks by the carried state."""
        Bsz, S, H, P = x.shape
        N = Bm.shape[-1]
        Q = min(self.cfg["ssm_chunk"], S)
        pad = -S % Q
        if pad:   # zero input and dt at the end: earlier outputs unchanged
            x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
            Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
        nc = (S + pad) // Q
        xr = x.reshape(Bsz, nc, Q, H, P)
        dtr = dt.reshape(Bsz, nc, Q, H)
        Br, Cr = Bm.reshape(Bsz, nc, Q, N), Cm.reshape(Bsz, nc, Q, N)
        acs = (dtr * A).cumsum(2)                            # [B, c, Q, H]
        tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        diff = acs[:, :, :, None, :] - acs[:, :, None, :, :]  # [B,c,t,s,H]
        L = torch.exp(diff.masked_fill(~tri[:, :, None], float("-inf")))
        W = torch.einsum("bctn,bcsn->bcts", Cr, Br)[..., None] * L
        xdt = xr * dtr[..., None]
        y = torch.einsum("bctsh,bcshp->bcthp", W, xdt)
        to_end = torch.exp(acs[:, :, -1:, :] - acs)          # [B, c, Q, H]
        states = torch.einsum("bcsh,bcshp,bcsn->bchpn", to_end, xdt, Br)
        decay = torch.exp(acs[:, :, -1, :])                  # [B, c, H]
        h = torch.zeros(Bsz, H, P, N, dtype=x.dtype, device=x.device)
        carried = []
        for c in range(nc):
            carried.append(h)
            h = h * decay[:, c, :, None, None] + states[:, c]
        y = y + (torch.einsum("bctn,bchpn->bcthp", Cr, torch.stack(carried, 1))
                 * torch.exp(acs)[..., None])
        return y.reshape(Bsz, nc * Q, H, P)[:, :S]

    def mamba(self, p, u):
        cfg = self.cfg
        B, S, D = u.shape
        d_in, N = cfg["ssm_expand"] * D, cfg["ssm_state"]
        P = cfg["ssm_head_dim"]
        H, K = d_in // P, cfg["ssm_conv"]
        zxbcdt = self.mm(u, p["in_proj"])
        z, xBC = zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * N]
        dt = zxbcdt[..., -H:]
        xp = F.pad(xBC, (0, 0, K - 1, 0))
        xBC = F.silu(sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(K))
                     + p["conv_b"])
        x = xBC[..., :d_in].reshape(B, S, H, P)
        Bm, Cm = xBC[..., d_in:d_in + N], xBC[..., d_in + N:]
        dt = F.softplus(dt + p["dt_bias"])
        y = self.ssd(self.q(x), dt, -torch.exp(p["A_log"]), self.q(Bm),
                     self.q(Cm))
        y = (y + x * p["D"][:, None]).reshape(B, S, d_in)
        y = rmsnorm(y * F.silu(z), p["norm_scale"], self.eps)
        return self.mm(y, p["out_proj"])

    # ------------------------------------------------------------ layers
    def layer(self, sp, h, cap_len: int):
        """One sub-layer: -> (h, aux loss of its MoE or 0)."""
        x = rmsnorm(h, sp["mixer_norm"], self.eps)
        if "attn" in sp:
            h = h + self.attention(sp["attn"], x)
        else:
            h = h + self.mamba(sp["mamba"], x)
        aux = h.new_zeros(())
        if "ffn_norm" in sp:
            x = rmsnorm(h, sp["ffn_norm"], self.eps)
            if "moe" in sp:
                y, logits = self.moe(sp["moe"], x, cap_len)
                aux = self.aux_loss(logits)
            else:
                y = self.mlp(sp["mlp"], x)
            h = h + y
        return h, aux

    def unit(self, up, h, cap_len: int):
        """One unit, its sub-layers (``sub0``, ``sub1``, ...) in order: ->
        (h, the sum of their aux losses)."""
        aux = h.new_zeros(())
        for j in range(len(up)):
            h, a = self.layer(up[f"sub{j}"], h, cap_len)
            aux = aux + a
        return h, aux

    def head(self, params):
        return (params["embed"].T if self.cfg.get("tie_embeddings", False)
                else params["lm_head"])

    def _ce_rows(self, h, labels, norm, head):
        logits = self.mm(rmsnorm(h, norm, self.eps), head)
        return F.cross_entropy(logits, labels.long(), reduction="sum")

    def loss(self, params, tokens, labels):
        """The train loss: token-mean cross-entropy plus
        ``aux_loss_weight`` times the sum of the layers' load-balancing
        losses."""
        h = params["embed"][tokens.long()]
        S = tokens.shape[1]
        aux = h.new_zeros(())
        for up in params["units"]:
            h, a = checkpoint(self.unit, up, h, S, use_reentrant=False)
            aux = aux + a
        hf, lf = h.reshape(-1, h.shape[-1]), labels.reshape(-1)
        head = self.head(params)
        ce = sum(checkpoint(self._ce_rows, hf[r:r + CE_ROWS],
                            lf[r:r + CE_ROWS], params["final_norm"], head,
                            use_reentrant=False)
                 for r in range(0, hf.shape[0], CE_ROWS)) / hf.shape[0]
        return ce + self.cfg.get("aux_loss_weight", 0.0) * aux


# ---------------------------------------------------------------- train

def _decays(path: tuple) -> bool:
    """The training recipe's decay rule: every leaf of a layer, and the
    top-level matrices (the embedding, the LM head), not the final
    norm."""
    return path[0] == "units" or path[0] in ("embed", "lm_head")


def lr_at(mix: dict, step: int) -> float:
    """Linear warm-up over ``warmup_steps``, then a cosine decay to
    ``min_lr_ratio`` of the peak at ``total_steps``."""
    o = mix["adamw"]
    peak, warm, total = mix["lr"], o["warmup_steps"], mix["schedule_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * 0.5
                   * (1 + math.cos(math.pi * prog)))


def train_readings_on(spec: list[weights.Leaf], cfg: dict, mix: dict,
                      seed: int, device, *, model=Model,
                      lowp: str | None = None, rows: slice | None = None,
                      steps: int = 3) -> dict:
    """``steps`` AdamW steps of the reference ``model`` (the class) over the
    leaves ``spec`` from the seed's weights on the seed's batches (``rows``
    of each, where given): each step's loss, the first clipped gradient's
    norm per leaf, and each leaf's change after the last step."""
    if device.type == "cuda":
        no_tf32()
    model = model(cfg, lowp)
    o = mix["adamw"]
    params: dict = {}
    for leaf in spec:
        weights.insert(params, leaf.path, weights.draw(
            leaf, seed, device, torch.float32).requires_grad_(True))
    flat = [weights.get(params, leaf.path) for leaf in spec]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    losses, first = [], {}
    for t in range(1, steps + 1):
        batch = traffic.train_batch(cfg, mix, seed, t - 1, device, rows)
        loss = model.loss(params, batch["tokens"], batch["labels"])
        grads = torch.autograd.grad(loss, flat)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(o["clip_norm"] / (gnorm + 1e-9), max=1.0)
            b1, b2 = o["b1"], o["b2"]
            b1c, b2c, lr = 1 - b1 ** t, 1 - b2 ** t, lr_at(mix, t)
            for leaf, p, g, mu, nu in zip(spec, flat, grads, m, v):
                g = g * scale
                if t == 1:
                    first[leaf.path] = float(g.norm())
                mu.mul_(b1).add_((1 - b1) * g)
                nu.mul_(b2).add_((1 - b2) * g * g)
                upd = (mu / b1c) / ((nu / b2c).sqrt() + o["eps"])
                if _decays(leaf.path):
                    upd = upd + o["weight_decay"] * p
                p.sub_(lr * upd)
                p.copy_(p.to(getattr(torch, leaf.dtype)).float())
        del grads
    del m, v
    change = {}
    with torch.no_grad():
        for leaf, p in zip(spec, flat):
            p0 = weights.draw(leaf, seed, device, torch.float32)
            change[leaf.path] = float((p - p0).norm())
    return {"losses": losses, "first_grad": first, "change": change}


# ---------------------------------------------------------------- serve

@torch.no_grad()
def serve_logits_on(spec: list[weights.Leaf], cfg: dict, seed: int,
                    requests: list[dict], device,
                    lowp_too: str | None = None, *, model=Model) -> list:
    """For each request ``{"prompt": [L] int, "served": [n] int}``, the
    reference ``model``'s (the class) logits [n, V] at the positions that
    chose the served tokens (the last prompt position, then each served
    token but the last), a unit at a time with that unit's leaves of
    ``spec`` drawn again.  With ``lowp_too`` also the control's, as a
    second list, and a third: at each of those positions the narrowest
    margin between the k-th and the next router logit over the MoE layers
    (the nearest routing tie; empty without MoE)."""
    if device.type == "cuda":
        no_tf32()
    models = [model(cfg)] + ([model(cfg, lowp_too)] if lowp_too else [])
    units: dict = {}
    for leaf in spec:
        if leaf.path[0] == "units":
            units.setdefault(leaf.path[1], []).append(leaf)
    top_spec = [leaf for leaf in spec if leaf.path[0] != "units"]
    embed = weights.draw(next(leaf for leaf in top_spec
                              if leaf.path == ("embed",)),
                         seed, device, torch.float32)
    seqs = [torch.cat([r["prompt"], r["served"][:-1]]).to(device).long()
            for r in requests]
    hs = [[embed[s][None] for s in seqs] for _ in models]
    del embed
    margins = [None] * len(requests)
    for i in sorted(units):
        up: dict = {}
        for leaf in units[i]:
            weights.insert(up, leaf.path[2:], weights.draw(
                leaf, seed, device, torch.float32))
        for side, h in zip(models, hs):
            for j, r in enumerate(requests):
                side.margins = [] if lowp_too and side is models[0] else None
                h[j] = side.unit(up, h[j], len(r["prompt"]))[0]
                for m in side.margins or []:
                    m = m[0, len(r["prompt"]) - 1:]
                    margins[j] = m if margins[j] is None else torch.minimum(
                        margins[j], m)
        del up
    top: dict = {}
    for leaf in top_spec:
        weights.insert(top, leaf.path, weights.draw(leaf, seed, device,
                                                    torch.float32))
    out = []
    for side, h in zip(models, hs):
        head = side.head(top)
        out.append([side.mm(rmsnorm(x[0, len(r["prompt"]) - 1:],
                                    top["final_norm"], side.eps), head)
                    for x, r in zip(h, requests)])
    if lowp_too:
        out.append([[] if m is None else m.tolist() for m in margins])
    return out


# ------------------------------------------------------- the architecture

def _mixer(cfg: dict) -> str:
    if cfg["family"] in ("dense", "moe"):
        return "attn"
    if cfg["family"] == "ssm":
        return "mamba"
    raise ValueError(f"family {cfg['family']!r} has no weights layout here")


def _ffn(cfg: dict) -> str | None:
    if cfg.get("d_ff", 0) <= 0:
        return None
    return "moe" if cfg.get("n_experts", 0) else "mlp"


def leaves(cfg: dict) -> list[weights.Leaf]:
    """The embedding, ``n_layers`` units of one sub-layer each (the
    family's mixer, then its FFN, if any), the final norm and the LM head
    (none where the embedding is tied)."""
    first, last = weights.top_leaves(cfg)
    mixer, ffn = _mixer(cfg), _ffn(cfg)
    return first + [leaf for i in range(cfg["n_layers"])
                    for leaf in weights.sublayer_leaves(
                        cfg, ("units", i, "sub0"), mixer, ffn)] + last


def mixers(cfg: dict) -> dict[str, int]:
    return {"attn": 0, "mamba": 0, _mixer(cfg): cfg["n_layers"]}


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file: the file's keys
    that are the dataclass's fields."""
    from repro_torch.configs.base import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})

