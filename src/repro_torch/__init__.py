"""PyTorch/CUDA port of the JAX package ``repro``, slice by slice.

The port keeps the JAX package's module names (``configs``, ``models``,
``kernels``, ``launch``) so that each module's counterpart is easy to find.
It imports ``torch`` and never ``jax`` or ``repro``: what it needs from the
JAX package it keeps as its own copy.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
