"""Training, distillation and their data on the card: the counterpart of
``ideepcolor_tpu/train`` (single device)."""
