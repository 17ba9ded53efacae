"""txr_torch.fusion: counterpart of txr.fusion."""
