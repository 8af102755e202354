"""qaig_tpu_torch -- the PyTorch / CUDA port of ``qaig_tpu``.

The port mirrors ``qaig_tpu``'s module tree (``ops``, ``models``, ``infer``,
``train``, ``parallel``, ``data``, ``native``, ``utils``, ``cli``, and
``scripts`` for the repo's ``scripts/``) so each counterpart is found by
its path.  It
imports ``torch`` and never ``jax`` or anything of ``qaig_tpu``: it reads
and writes the same numpy-pickle checkpoints and converts the parameter
layouts itself (``qaig_tpu_torch.convert``).

Every kernel that the repo wrote in Pallas for the TPU has a hand-written
CUDA C++ kernel for Hopper here (``qaig_tpu_torch/csrc``), built with
``nvcc`` at first use.  On a CUDA tensor an op launches its
kernel; on a CPU tensor it runs its plain PyTorch version.  Entry points
run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
