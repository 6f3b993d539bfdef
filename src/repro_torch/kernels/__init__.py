"""Hand-written Hopper kernels, their plain versions and the op wrappers.

* :mod:`~repro_torch.kernels.pasm_matmul` — ``ConvGeom``, the plain
  ``patch_tile`` gather and the two fused-dequant launch wrappers (K1
  ``pasm_matmul_kernel_call``, K2 ``pasm_conv_kernel_call``), and the launch
  counters of all six kernels;
* :mod:`~repro_torch.kernels.pas_histogram` — the paper-faithful two-phase
  PAS launch wrappers (K3 ``pas_matmul_kernel_call``, K4
  ``pas_conv_kernel_call``) and their plain versions;
* :mod:`~repro_torch.kernels.flash_attention` — the GQA flash-attention
  launch wrapper (K5 ``flash_attention_kernel_call``) and its plain version;
* :mod:`~repro_torch.kernels.decode_attention` — split-KV decode attention
  over a KV cache (K6 ``decode_attention_kernel_call``, no TPU kernel's
  port), its plain version and the wrapper ``attend``;
* :mod:`~repro_torch.kernels.ops` — shape plumbing, the Hopper tile plan and
  the K1/K2 autograd Functions (the PASM backwards);
* :mod:`~repro_torch.kernels.ref` — the plain versions;
* :mod:`~repro_torch.kernels._build` — ``nvcc`` + ``ctypes`` loading of
  ``csrc/*.cu`` at first use.
"""
