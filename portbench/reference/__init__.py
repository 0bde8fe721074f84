"""The benchmark's plain reference: the models, the SGHMC update and the BMA
sums in plain PyTorch, written from the papers and the URSABench protocol.
Each architecture is a module of its own (``preresnet.py``,
``wideresnet.py``), found by the name a configuration gives it
(``models.py``).

Nothing here imports the program under test (``ursabench_tpu_torch``), the
JAX package or JAX. The reference computes in float32; ``Precision`` puts it
in a lower precision for the controls (TF32, or fp8 with per-tensor scales).
"""
