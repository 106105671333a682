"""Weights drawn on the device from the seed, leaf by leaf.

Each leaf has a generator of its own, seeded from (seed, the leaf's path),
so any leaf, or one layer's leaves, can be drawn again alone and comes out
bit-equal: the program gets the whole tree once, and the reference draws
each layer again when it needs it, in float32 from the same values.  A
leaf is drawn in one call, in the dtype it is served in.

The tree has the port's layout (a list of units of one sub-layer each, the
weights [in, out]); ``leaves`` is the benchmark's own statement of it.
Distributions (the configuration file lists them under ``assumed``):
products N(0, 1/fan_in); the embedding N(0, 1/d_model); norm scales
N(1, 0.1^2); the Mamba mixer's A = -exp(A_log) with exp(A_log) uniform in
[1, 16], dt_bias the inverse softplus of a log-uniform dt in [1e-3, 1e-1]
(the Mamba-2 paper's initialisation), D ~ N(1, 0.1^2), the conv bias
N(0, 0.1^2).
"""

from __future__ import annotations

import hashlib
import math
from typing import NamedTuple

import torch


class Leaf(NamedTuple):
    path: tuple
    shape: tuple
    dtype: str        # torch dtype name
    init: str         # normal | norm | a_log | dt_bias
    scale: float      # std (normal, norm)


def derive(seed: int, tag: str) -> int:
    """A 63-bit generator seed for ``tag`` under ``seed`` (any int)."""
    digest = hashlib.blake2b(f"{seed}/{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def mixer(cfg: dict) -> str:
    if cfg["family"] in ("dense", "moe"):
        return "attn"
    if cfg["family"] == "ssm":
        return "mamba"
    raise ValueError(f"family {cfg['family']!r} has no weights layout here")


def ffn(cfg: dict) -> str | None:
    if cfg.get("d_ff", 0) <= 0:
        return None
    return "moe" if cfg.get("n_experts", 0) else "mlp"


def layer_leaves(cfg: dict, i: int) -> list[Leaf]:
    D, dt = cfg["d_model"], cfg["dtype"]
    u = ("units", i, "sub0")
    out = [Leaf(u + ("mixer_norm",), (D,), dt, "norm", 0.1)]
    if mixer(cfg) == "attn":
        H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        a = u + ("attn",)
        out += [Leaf(a + ("wq",), (D, H * hd), dt, "normal", D ** -0.5),
                Leaf(a + ("wk",), (D, KV * hd), dt, "normal", D ** -0.5),
                Leaf(a + ("wv",), (D, KV * hd), dt, "normal", D ** -0.5),
                Leaf(a + ("wo",), (H * hd, D), dt, "normal",
                     (H * hd) ** -0.5)]
    else:
        d_in = cfg["ssm_expand"] * D
        N, P, K = cfg["ssm_state"], cfg["ssm_head_dim"], cfg["ssm_conv"]
        H, ch = d_in // P, d_in + 2 * N
        m = u + ("mamba",)
        out += [Leaf(m + ("in_proj",), (D, 2 * d_in + 2 * N + H), dt,
                     "normal", D ** -0.5),
                Leaf(m + ("conv_w",), (K, ch), dt, "normal", K ** -0.5),
                Leaf(m + ("conv_b",), (ch,), dt, "normal", 0.1),
                Leaf(m + ("A_log",), (H,), "float32", "a_log", 0.0),
                Leaf(m + ("D",), (H,), "float32", "norm", 0.1),
                Leaf(m + ("dt_bias",), (H,), "float32", "dt_bias", 0.0),
                Leaf(m + ("norm_scale",), (d_in,), dt, "norm", 0.1),
                Leaf(m + ("out_proj",), (d_in, D), dt, "normal",
                     d_in ** -0.5)]
    kind = ffn(cfg)
    if kind:
        F = cfg["d_ff"]
        out.append(Leaf(u + ("ffn_norm",), (D,), dt, "norm", 0.1))
        if kind == "moe":
            E, f = cfg["n_experts"], u + ("moe",)
            out += [Leaf(f + ("router",), (D, E), "float32", "normal",
                         D ** -0.5),
                    Leaf(f + ("w_gate",), (E, D, F), dt, "normal", D ** -0.5),
                    Leaf(f + ("w_up",), (E, D, F), dt, "normal", D ** -0.5),
                    Leaf(f + ("w_down",), (E, F, D), dt, "normal",
                         F ** -0.5)]
        else:
            f = u + ("mlp",)
            out += [Leaf(f + ("w_gate",), (D, F), dt, "normal", D ** -0.5),
                    Leaf(f + ("w_up",), (D, F), dt, "normal", D ** -0.5),
                    Leaf(f + ("w_down",), (F, D), dt, "normal", F ** -0.5)]
    return out


def top_leaves(cfg: dict) -> tuple[list[Leaf], list[Leaf]]:
    """The leaves before the layers (the embedding) and after them."""
    D, V, dt = cfg["d_model"], cfg["vocab_size"], cfg["dtype"]
    head = [Leaf(("final_norm",), (D,), dt, "norm", 0.1)]
    if not cfg.get("tie_embeddings", False):
        head.append(Leaf(("lm_head",), (D, V), dt, "normal", D ** -0.5))
    return [Leaf(("embed",), (V, D), dt, "normal", D ** -0.5)], head


def leaves(cfg: dict) -> list[Leaf]:
    first, last = top_leaves(cfg)
    return first + [leaf for i in range(cfg["n_layers"])
                    for leaf in layer_leaves(cfg, i)] + last


def draw(leaf: Leaf, seed: int, device, dtype=None) -> torch.Tensor:
    """The leaf's values, bit-equal on every call with the same seed and
    device; cast to ``dtype`` where one is given."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, "/".join(map(str, leaf.path))))
    t = torch.empty(leaf.shape, dtype=getattr(torch, leaf.dtype),
                    device=device)
    if leaf.init == "normal":
        t.normal_(0.0, leaf.scale, generator=g)
    elif leaf.init == "norm":
        t.normal_(1.0, leaf.scale, generator=g)
    elif leaf.init == "a_log":
        t.uniform_(1.0, 16.0, generator=g).log_()
    elif leaf.init == "dt_bias":
        dt0 = t.uniform_(math.log(1e-3), math.log(1e-1), generator=g).exp_()
        t = dt0 + torch.log(-torch.expm1(-dt0))      # softplus^-1(dt0)
    else:
        raise ValueError(f"unknown init {leaf.init!r}")
    return t if dtype is None else t.to(dtype)


def insert(tree: dict, path: tuple, value) -> None:
    """Put ``value`` at ``path`` (dict keys, list indices in order)."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def tree(cfg: dict, seed: int, device, dtype=None) -> dict:
    """Every leaf, in the port's tree layout."""
    out: dict = {}
    for leaf in leaves(cfg):
        insert(out, leaf.path, draw(leaf, seed, device, dtype))
    return out


def get(tree_: dict, path: tuple):
    node = tree_
    for key in path:
        node = node[key]
    return node
