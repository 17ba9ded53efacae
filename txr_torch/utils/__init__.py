"""Utilities of the port (the counterpart of ``txr.utils``)."""

from txr_torch.utils.visualize import (print_cloud_stats,
                                       visualize_reconstruction,
                                       visualize_with_plotly)

__all__ = ["print_cloud_stats", "visualize_reconstruction",
           "visualize_with_plotly"]
