"""Training on one device: AdamW, error-feedback gradient compression, the
train step and checkpoints, the parts of :mod:`repro.train` that run
without a mesh."""
