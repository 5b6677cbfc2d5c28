from repro_torch.data.pipeline import MemmapDataset, SyntheticDataset  # noqa: F401
