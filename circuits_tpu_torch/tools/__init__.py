"""The port's command-line entry point (`python -m circuits_tpu_torch.tools.cli`)."""
