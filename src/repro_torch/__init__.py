"""PyTorch/CUDA port of the Parrot reproduction (``repro``), one slice at a
time.  The JAX package stays the reference; this package imports neither
``jax`` nor ``repro``.  Module paths mirror ``src/repro/`` one to one.

Entry points run on the card (``cuda:0``) unless the caller asks for the
CPU with ``device="cpu"``; asking for CUDA without a card raises.
"""
