"""The benchmark's plain reference: the two UNets, the DeltaBlocks and the
DDIM chains of an edit, written out in plain PyTorch from the published
architectures.

It imports neither JAX nor anything of the program under test. It reads
the weights, images and noise that the benchmark makes from the seed, and
works out again everything the program derives from them (the schedule,
the timesteps, which steps are edited and which draw noise). Every
convolution, matrix product, GroupNorm and attention goes through one `ops.RefOps` object, which can
round the operands of the products to a lower precision (the control of
`correct`) and can count their operations and bytes (the benchmark's
yardstick for MFU and rooflines).
"""
