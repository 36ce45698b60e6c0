"""Entry points of the port (counterpart of repro.launch): the serving
driver, `python -m repro_torch.launch.serve`."""
