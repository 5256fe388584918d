"""Command-line entry points of the port (`python -m
pillarnet_lts_torch.tools.<name>`)."""
