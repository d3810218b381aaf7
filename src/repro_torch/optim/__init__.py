"""Optimization-side utilities of the port: :mod:`repro_torch.optim.compress`
(the int8 wire of the model-parallel combine and the error-feedback
gradient mean).  The reference's optimizers wait for the LM side."""
