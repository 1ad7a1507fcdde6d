"""Entry points of the model zoo (``python -m repro_torch.launch.serve``)."""
