"""Host I/O of the port: PLY, depth maps, frame sources (the counterpart
of ``txr.io``, with the same names)."""

from txr_torch.io.ply import write_ply, read_ply
from txr_torch.io.depth_io import (
    load_depth,
    find_matching_depth,
    save_depth_npy,
    save_depth_png16,
    save_depth_vis,
    depth_to_colormap,
    get_colormap,
)
from txr_torch.io.sources import (
    ImageSource,
    FolderSource,
    VideoSource,
    CameraSource,
    PrefetchSource,
    make_source,
)

__all__ = [
    "write_ply",
    "read_ply",
    "load_depth",
    "find_matching_depth",
    "save_depth_npy",
    "save_depth_png16",
    "save_depth_vis",
    "depth_to_colormap",
    "get_colormap",
    "ImageSource",
    "FolderSource",
    "VideoSource",
    "CameraSource",
    "PrefetchSource",
    "make_source",
]
