"""OpenCV is optional for the port's host I/O, as it is for ``txr``'s: the
JPEG and 16-bit PNG codecs are native, and ``cv2`` serves the other image
formats, video and cameras, the colormap and the preview window.

``txr``'s modules import ``cv2`` at import time; the port's import it at
first use, so that importing ``txr_torch`` never loads it (a machine with
the card need not have it).
"""

from __future__ import annotations


def cv2_or_none():
    """The ``cv2`` module, or None when OpenCV is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def require_cv2(what: str):
    """The ``cv2`` module; ImportError naming ``what`` needs it otherwise."""
    cv2 = cv2_or_none()
    if cv2 is None:
        raise ImportError(f"OpenCV (opencv-python) is required for {what}")
    return cv2
