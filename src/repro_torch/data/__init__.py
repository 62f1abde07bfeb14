from repro_torch.data.pipeline import DataConfig, DataPipeline, make_batch_fn
