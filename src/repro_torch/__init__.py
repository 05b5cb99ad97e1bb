"""PyTorch/CUDA port of the diffeomorphic registration solver in ``repro``.

The layout mirrors ``repro`` module by module (``core/grid.py``,
``kernels/ref.py``, ...), so each module's counterpart is found under the
same path.  The package imports ``torch``, numpy and the standard library
only; it never imports JAX or ``repro``.

Entry points take ``device=`` and default to ``"cuda"``; asking for CUDA on
a machine without it raises (``repro_torch.device.resolve_device``).  On a
CUDA device every tricubic interpolation of the solve runs through the
hand-written kernels in ``kernels/csrc/tricubic.cu``.
"""
