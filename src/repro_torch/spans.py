"""Spans and counters inside the port's model, train and serve paths, on
``torch.profiler``'s clock.

``span(name)`` is a ``torch.profiler.record_function(name)`` while a
profiler session is active, and one shared no-op context otherwise: with
no profiler running, a span costs a flag check.  Under the profiler each
span lands in the same Chrome trace as the device's kernels, as a
``user_annotation`` event; a kernel is tied by its correlation id to the
launch that made it, and so to every span open on the host at that time.
The spans (all named ``rt.*``) and what reads them:

  rt.train.forward, rt.train.backward
                        ``train/step.py``: ``model.loss``; autograd's
                        backward, each checkpointed unit's recompute
                        included
  rt.train.optimizer    ``optim/adamw.py``: ``AdamW.update`` on CUDA
                        leaves (the gradient pointers' copy and the three
                        AdamW kernels); the CPU's plain loop records none
  rt.serve.decode_step  ``launch/serve.py``: one decode step (the model's
                        step, the argmax and the finite flag)
  rt.attention          ``models/transformer.py``: a unit's attention
                        (QKV, rotary, cache write, attention)
  rt.moe.route, rt.moe.dispatch, rt.moe.experts, rt.moe.combine
                        ``models/moe.py``: ``moe_ffn``'s four parts
  rt.mamba              ``models/mamba.py``: the Mamba-2 mixer, SSD scan
                        included

The MoE counters (``count_moe``) add up, while a profiler session is
active, the (token, choice) pairs that ``moe_ffn`` keeps and the rows of
the expert buffers it computes.  Counting waits for nothing: a call's
routing mask (bool, B x k*S) is held on the device, and every ``FOLD``
held masks are summed into one device total (three launches).
``kernels.ops.launch_counts`` reads the counters beside the kernels'
launch counters, and ``reset_launch_counts`` zeroes them.

This module is a leaf: the model and kernel layers import it, so it
imports nothing of the port.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()

#: The counters ``counts`` returns.
COUNTERS = ("moe_pairs_kept", "moe_buffer_rows")
#: Held routing masks that are summed into the running total.
FOLD = 64

_masks: list[torch.Tensor] = []    # routing masks not yet in ``_kept``
_kept: torch.Tensor | int = 0      # kept pairs of the folded masks (device)
_buffer_rows = 0


def active() -> bool:
    """Whether a profiler session is recording."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A context that records a span ``name`` under the profiler, and does
    nothing otherwise."""
    return torch.profiler.record_function(name) if active() else _OFF


def _fold() -> None:
    global _kept
    if _masks:
        _kept = _kept + torch.cat([m.reshape(-1) for m in _masks]).sum()
        _masks.clear()


def count_moe(keep: torch.Tensor, buffer_rows: int) -> None:
    """Count a ``moe_ffn`` call's kept pairs (``keep``, the routing's mask)
    and buffer rows, under the profiler only."""
    global _buffer_rows
    if active():
        _masks.append(keep)
        _buffer_rows += buffer_rows
        if len(_masks) >= FOLD:
            _fold()


def counts() -> dict[str, int]:
    """The counters since the last reset (reading the kept pairs waits for
    the device)."""
    _fold()
    return {"moe_pairs_kept": int(_kept), "moe_buffer_rows": _buffer_rows}


def reset_counts() -> None:
    global _kept, _buffer_rows
    _masks.clear()
    _kept = 0
    _buffer_rows = 0
