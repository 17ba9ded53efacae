"""RTAB-Map sqlite database replay source, the counterpart of
``txr/io/rtabmap_db.py``.

Parity with the reference's db_player_node (ros2_ws/src/monocular_slam/
monocular_slam/db_player_node.py): replays JPEG frames stored in an RTAB-Map
session database (`SELECT Node.id FROM Node JOIN Data ... WHERE Data.image IS
NOT NULL`), parses the binary calibration blob (int32 width/height at indices
4/5; float64 K-matrix row-major at byte offset 44 — layout reverse-engineered
by the reference's get_calibration.py), and rescales intrinsics when the
decoded image size differs from the calibration size.

Schema (reference db_schema.txt): tables Node(id, pose, stamp, ...) and
Data(id, image JPEG blob, depth blob, calibration blob, ...).
"""

from __future__ import annotations

import sqlite3
from typing import Iterator, Optional, Tuple

import numpy as np

from txr_torch.core.intrinsics import CameraIntrinsics
from txr_torch.io.opencv import require_cv2
from txr_torch.io.sources import Frame, ImageSource


def parse_calibration_blob(blob: bytes) -> Optional[CameraIntrinsics]:
    """RTAB-Map calibration blob → intrinsics (offset-44 float64 K layout)."""
    try:
        ints = np.frombuffer(blob, dtype=np.int32)
        width = int(ints[4])
        height = int(ints[5])
        doubles = np.frombuffer(blob, dtype=np.float64, offset=44)
        fx, cx, fy, cy = float(doubles[0]), float(doubles[2]), float(doubles[4]), float(doubles[5])
        if fx <= 0 or fy <= 0 or width <= 0 or height <= 0:
            return None
        return CameraIntrinsics(fx=fx, fy=fy, cx=cx, cy=cy,
                                width=width, height=height)
    except (IndexError, ValueError):
        return None


class RTABMapDBSource(ImageSource):
    """Iterate frames out of an RTAB-Map .db session file."""

    def __init__(self, db_path: str, loop: bool = False,
                 framerate: float = 30.0):
        # check_same_thread=False: PrefetchSource iterates sources on a
        # worker thread; access is single-consumer, so no lock is needed.
        self.conn = sqlite3.connect(db_path, check_same_thread=False)
        self.cursor = self.conn.cursor()
        self.loop = loop
        self.framerate = framerate
        self.cursor.execute(
            "SELECT Node.id FROM Node JOIN Data ON Node.id = Data.id "
            "WHERE Data.image IS NOT NULL ORDER BY Node.id ASC")
        self.ids = [row[0] for row in self.cursor.fetchall()]
        if not self.ids:
            raise ValueError(f"No images found in RTAB-Map DB: {db_path}")
        self.index = 0
        self._calib = self._load_calibration()
        self.intrinsics = self._calib  # may be rescaled on first frame

    def _load_calibration(self) -> Optional[CameraIntrinsics]:
        self.cursor.execute(
            "SELECT calibration FROM Data WHERE calibration IS NOT NULL LIMIT 1")
        row = self.cursor.fetchone()
        if row and row[0]:
            return parse_calibration_blob(row[0])
        return None

    def __len__(self) -> int:
        return len(self.ids)

    def __next__(self) -> Frame:
        # Bound one call to a single pass over the id list so a DB whose
        # every blob fails to decode stops (or, when looping, raises) instead
        # of busy-spinning forever inside a replay timer.
        cv2 = require_cv2("decoding RTAB-Map images")
        for _ in range(len(self.ids) + 1):
            if self.index >= len(self.ids):
                if self.loop:
                    self.index = 0
                else:
                    raise StopIteration
            node_id = self.ids[self.index]
            self.index += 1
            self.cursor.execute("SELECT image FROM Data WHERE id = ?", (node_id,))
            row = self.cursor.fetchone()
            if not row or not row[0]:
                continue
            img = cv2.imdecode(np.frombuffer(row[0], np.uint8), cv2.IMREAD_COLOR)
            if img is None:
                continue
            h, w = img.shape[:2]
            if self.intrinsics is None:
                self.intrinsics = CameraIntrinsics.default(w, h)
            elif (self.intrinsics.width, self.intrinsics.height) != (w, h):
                # Rescale to the decoded size (reference :164-179).
                self.intrinsics = self.intrinsics.scaled(w, h)
            ts = (self.index - 1) / self.framerate
            return img, ts, f"node_{node_id:06d}"
        raise StopIteration  # full pass, nothing decodable

    def close(self):
        self.conn.close()


def db_info(db_path: str) -> dict:
    """Summarize an RTAB-Map DB (reference db_info.py capability)."""
    conn = sqlite3.connect(db_path)
    cur = conn.cursor()
    cur.execute("SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")
    tables = [r[0] for r in cur.fetchall()]
    out = {"tables": {}}
    for t in tables:
        try:
            cur.execute(f"SELECT COUNT(*) FROM '{t}'")
            count = cur.fetchone()[0]
        except sqlite3.Error:
            count = None
        cur.execute(f"PRAGMA table_info('{t}')")
        cols = [r[1] for r in cur.fetchall()]
        out["tables"][t] = {"rows": count, "columns": cols}
    conn.close()
    return out
