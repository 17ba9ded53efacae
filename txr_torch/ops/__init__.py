"""txr_torch.ops: counterpart of txr.ops."""
