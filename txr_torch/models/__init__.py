"""txr_torch.models: counterpart of txr.models."""
