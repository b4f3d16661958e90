"""Command-line entry points of the port (``python -m mocopci_torch.cli.test``)."""
