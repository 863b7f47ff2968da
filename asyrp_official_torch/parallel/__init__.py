"""Multi-device runs over `torch.distributed` (`mesh.py`, `multislice.py`,
`spatial.py`): one process per GPU, launched by `torchrun`."""
