from repro_torch.data.pipeline import DataConfig, SyntheticLM, MemmapTokens, Prefetcher, pack_documents  # noqa: F401
