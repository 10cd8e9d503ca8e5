from repro_torch.serving.engine import ServeTrace, ServingEngine  # noqa: F401
