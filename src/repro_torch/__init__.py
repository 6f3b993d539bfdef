"""PyTorch + CUDA port of the weight-shared PASM conv accelerator.

Mirrors the module paths of the JAX package ``repro`` so each counterpart is
easy to find, but imports nothing of it (nor ``jax``): the two packages only
meet in the tests, which feed both the same numpy inputs.

Ported so far: the quantized AlexNet serving path, the paper-faithful
two-phase PAS path, dense-transformer LM serving, and training:

* :mod:`repro_torch.core.pasm` — k-means weight sharing and int4 packing;
* :mod:`repro_torch.core.pas` — the PASM identity (PAS phase, post-pass);
* :mod:`repro_torch.core.hwmodel` — the paper's gate, power, FPGA and
  latency model;
* :mod:`repro_torch.core.params` — the ``PasmParams`` container;
* :mod:`repro_torch.core.conv` — ``ConvParams`` / ``Conv2D`` / ``conv2d``;
* :mod:`repro_torch.kernels` — five hand-written Hopper kernels (K1 the
  fused-dequant GEMM, K2 the implicit-GEMM conv, K3/K4 their two-phase PAS
  counterparts, K5 GQA flash attention) and their plain versions;
* :mod:`repro_torch.models.cnn` + :mod:`repro_torch.configs.alexnet_conv`;
* :mod:`repro_torch.configs` — the LM registry (the four dense archs) and
  :mod:`repro_torch.models.transformer` with :mod:`repro_torch.nn`;
* :mod:`repro_torch.serve` — the continuous-batching ``Engine``, its
  scheduler and fault plan, ``CnnBatcher`` and ``MixedBatcher``;
  :mod:`repro_torch.launch.serve` is the launcher;
* :mod:`repro_torch.core.qat` (the STE) and the CNN's QAT functions;
  :mod:`repro_torch.train` (AdamW, the guarded train steps, the crash-safe
  loop, its fault plan), :mod:`repro_torch.ckpt.checkpoint`,
  :mod:`repro_torch.ft`, :mod:`repro_torch.data.pipeline` and
  :mod:`repro_torch.launch.train`; :mod:`repro_torch.tree` walks the
  parameter trees;
* :mod:`repro_torch.interop` — carries the JAX package's weights across as
  numpy arrays.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper runs its plain version.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
