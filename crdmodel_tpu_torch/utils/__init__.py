from crdmodel_tpu_torch.utils.profiling import RunManifest, throughput, trace

__all__ = ["throughput", "trace", "RunManifest"]
