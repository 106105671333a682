"""The architecture module of the tests' hybrid configuration
(``bench_tiny.HYBRID``): the port's hybrid layout, each unit
``attn_layer_period`` sub-layers, the first attention and the rest Mamba-2
mixers, the last of every ``moe_layer_period`` a MoE FFN and the others a
dense one; its attention is NoPE (``rope_theta`` 0: no rotary embedding),
which the reference's ``Model`` does not state, so this module's ``Model``
overrides that block.  It is made of the shared pieces alone
(``weights``' leaf builders, ``reference``'s blocks), so that an
architecture joins the benchmark as new files."""

from benchlib import reference, weights

port_config = reference.port_config


class Model(reference.Model):
    def _rotary(self, x, pos):
        return x


def layout(cfg: dict) -> list[tuple[str, str]]:
    """(mixer, ffn) of each sub-layer of a unit."""
    period, moe = cfg["attn_layer_period"], cfg["moe_layer_period"]
    return [("attn" if j == 0 else "mamba",
             "moe" if j % moe == moe - 1 else "mlp") for j in range(period)]


def leaves(cfg: dict) -> list[weights.Leaf]:
    first, last = weights.top_leaves(cfg)
    subs = layout(cfg)
    return first + [
        leaf for i in range(cfg["n_layers"] // len(subs))
        for j, (mixer, ffn) in enumerate(subs)
        for leaf in weights.sublayer_leaves(cfg, ("units", i, f"sub{j}"),
                                            mixer, ffn)] + last


def mixers(cfg: dict) -> dict[str, int]:
    subs = layout(cfg)
    units = cfg["n_layers"] // len(subs)
    return {kind: units * sum(m == kind for m, _ in subs)
            for kind in ("attn", "mamba")}
