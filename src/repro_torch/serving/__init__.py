from repro_torch.serving.engine import ServeMetrics, ServingEngine  # noqa: F401
