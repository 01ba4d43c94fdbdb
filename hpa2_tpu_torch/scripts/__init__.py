"""The port's counterparts of the repo's ``scripts/``: tools run as
``python -m hpa2_tpu_torch.scripts.<name>``."""
