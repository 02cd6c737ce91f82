"""Feature database: persistent store of images, keypoints, descriptors,
matches, and two-view geometries.

Reference: retrieval/vlindex/src/base/database.h:50-52 — COLMAP's SQLite
database ("optimized for single-thread speed") holding cameras/images/
keypoints/descriptors/matches/two_view_geometries, with the pair_id =
image_id1 * 2147483647 + image_id2 convention for match tables, plus the
"skip if already present" incremental pattern (visual_index.h:211-214,
matching.cc:829-836).

Host-side by design (storage is not a TPU problem); arrays are stored as
raw little-endian blobs with shape columns, so reads land directly in
numpy and feed device batches without copies. WAL mode keeps the writer
fast while the extraction pipeline's writer thread streams rows in.
"""

from __future__ import annotations

import sqlite3
from typing import Iterator, Optional

import numpy as np

_MAX_IMAGE_ID = 2147483647

_SCHEMA = """
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL UNIQUE,
    width INTEGER,
    height INTEGER
);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB
);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    dtype TEXT NOT NULL,
    data BLOB
);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    data BLOB
);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    data BLOB,
    config INTEGER NOT NULL,
    model BLOB
);
CREATE TABLE IF NOT EXISTS global_features (
    image_id INTEGER PRIMARY KEY NOT NULL,
    dim INTEGER NOT NULL,
    data BLOB
);
"""


def pair_id_from_images(image_id1: int, image_id2: int) -> int:
    """COLMAP pair-id convention (order-independent storage key)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * _MAX_IMAGE_ID + image_id2


def images_from_pair_id(pair_id: int) -> tuple[int, int]:
    return pair_id // _MAX_IMAGE_ID, pair_id % _MAX_IMAGE_ID


class FeatureDatabase:
    """SQLite feature store. Use as a context manager or call close()."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)
        if path != ":memory:":
            self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=NORMAL")

    def close(self) -> None:
        self.conn.commit()
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- images -----------------------------------------------------------
    def add_image(self, name: str, width: int = 0, height: int = 0) -> int:
        cur = self.conn.execute(
            "INSERT OR IGNORE INTO images(name, width, height) VALUES(?,?,?)",
            (name, width, height))
        if cur.rowcount:
            return int(cur.lastrowid)
        row = self.conn.execute(
            "SELECT image_id FROM images WHERE name=?", (name,)).fetchone()
        return int(row[0])

    def image_id(self, name: str) -> Optional[int]:
        row = self.conn.execute(
            "SELECT image_id FROM images WHERE name=?", (name,)).fetchone()
        return None if row is None else int(row[0])

    def image_name(self, image_id: int) -> Optional[str]:
        row = self.conn.execute(
            "SELECT name FROM images WHERE image_id=?",
            (image_id,)).fetchone()
        return None if row is None else row[0]

    def num_images(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]

    def iter_images(self) -> Iterator[tuple[int, str]]:
        yield from self.conn.execute(
            "SELECT image_id, name FROM images ORDER BY image_id")

    # -- keypoints / descriptors -------------------------------------------
    def write_keypoints(self, image_id: int, keypoints) -> None:
        """keypoints [N, C>=2] float32 (x, y, sigma, angle, ...)."""
        kp = np.ascontiguousarray(np.asarray(keypoints, np.float32))
        self.conn.execute(
            "INSERT OR REPLACE INTO keypoints VALUES(?,?,?,?)",
            (image_id, kp.shape[0], kp.shape[1], kp.tobytes()))

    def read_keypoints(self, image_id: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (image_id,)).fetchone()
        if row is None:
            return None
        r, c, blob = row
        return np.frombuffer(blob, np.float32).reshape(r, c).copy()

    def write_descriptors(self, image_id: int, descriptors) -> None:
        d = np.ascontiguousarray(np.asarray(descriptors))
        self.conn.execute(
            "INSERT OR REPLACE INTO descriptors VALUES(?,?,?,?,?)",
            (image_id, d.shape[0], d.shape[1], d.dtype.str, d.tobytes()))

    def read_descriptors(self, image_id: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT rows, cols, dtype, data FROM descriptors "
            "WHERE image_id=?", (image_id,)).fetchone()
        if row is None:
            return None
        r, c, dt, blob = row
        return np.frombuffer(blob, np.dtype(dt)).reshape(r, c).copy()

    def has_features(self, image_id: int) -> bool:
        """The incremental-resume check (skip if already extracted)."""
        return self.conn.execute(
            "SELECT 1 FROM descriptors WHERE image_id=?",
            (image_id,)).fetchone() is not None

    # -- global features -----------------------------------------------------
    def write_global_feature(self, image_id: int, vec) -> None:
        v = np.ascontiguousarray(np.asarray(vec, np.float32)).ravel()
        self.conn.execute(
            "INSERT OR REPLACE INTO global_features VALUES(?,?,?)",
            (image_id, v.size, v.tobytes()))

    def read_global_feature(self, image_id: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT dim, data FROM global_features WHERE image_id=?",
            (image_id,)).fetchone()
        if row is None:
            return None
        return np.frombuffer(row[1], np.float32).copy()

    def read_all_global_features(self):
        """-> (image_ids [N] i64, matrix [N, D] f32) in id order."""
        rows = self.conn.execute(
            "SELECT image_id, dim, data FROM global_features "
            "ORDER BY image_id").fetchall()
        if not rows:
            return np.zeros(0, np.int64), np.zeros((0, 0), np.float32)
        ids = np.array([r[0] for r in rows], np.int64)
        mat = np.stack([np.frombuffer(r[2], np.float32) for r in rows])
        return ids, mat

    # -- matches / two-view geometries ---------------------------------------
    def write_matches(self, image_id1: int, image_id2: int, matches) -> None:
        """matches [N, 2] int32 (idx in image1, idx in image2)."""
        m = np.ascontiguousarray(np.asarray(matches, np.int32))
        if image_id1 > image_id2:           # store in canonical order
            m = m[:, ::-1].copy()
        self.conn.execute(
            "INSERT OR REPLACE INTO matches VALUES(?,?,?)",
            (pair_id_from_images(image_id1, image_id2), m.shape[0],
             m.tobytes()))

    def read_matches(self, image_id1: int,
                     image_id2: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT rows, data FROM matches WHERE pair_id=?",
            (pair_id_from_images(image_id1, image_id2),)).fetchone()
        if row is None:
            return None
        m = np.frombuffer(row[1], np.int32).reshape(row[0], 2).copy()
        return m[:, ::-1].copy() if image_id1 > image_id2 else m

    def has_matches(self, image_id1: int, image_id2: int) -> bool:
        return self.conn.execute(
            "SELECT 1 FROM matches WHERE pair_id=?",
            (pair_id_from_images(image_id1, image_id2),)).fetchone() \
            is not None

    def write_two_view_geometry(self, image_id1: int, image_id2: int,
                                inlier_matches, config: int = 2,
                                model=None) -> None:
        """config mirrors TwoViewGeometry::ConfigurationType (2 =
        calibrated/F, 3 = homography, ...); model = flattened matrix."""
        m = np.ascontiguousarray(np.asarray(inlier_matches, np.int32))
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()
        mdl = (b"" if model is None else
               np.ascontiguousarray(np.asarray(model, np.float64)).tobytes())
        self.conn.execute(
            "INSERT OR REPLACE INTO two_view_geometries VALUES(?,?,?,?,?)",
            (pair_id_from_images(image_id1, image_id2), m.shape[0],
             m.tobytes(), config, mdl))

    def read_two_view_geometry(self, image_id1: int, image_id2: int):
        row = self.conn.execute(
            "SELECT rows, data, config, model FROM two_view_geometries "
            "WHERE pair_id=?",
            (pair_id_from_images(image_id1, image_id2),)).fetchone()
        if row is None:
            return None
        m = np.frombuffer(row[1], np.int32).reshape(row[0], 2).copy()
        if image_id1 > image_id2:
            m = m[:, ::-1].copy()
        model = (None if not row[3] else np.frombuffer(row[3], np.float64))
        return m, int(row[2]), model

    def commit(self) -> None:
        self.conn.commit()

    # -- management (exe/database.cc, exe/image.cc) -----------------------
    def clear(self, what: str = "all") -> None:
        """Clear tables (RunDatabaseCleaner, exe/database.cc:40-78):
        'all' | 'images' (images + every dependent table) | 'features'
        (keypoints/descriptors/global features) | 'matches' (matches +
        two-view geometries)."""
        # 'images' clears images + every dependent table; with no
        # separate cameras table here, 'all' is the same set (the
        # reference's RunDatabaseCleaner distinguishes them only by its
        # cameras table)
        _images_tables = ("images", "keypoints", "descriptors",
                          "global_features", "matches",
                          "two_view_geometries")
        plans = {
            "all": _images_tables,
            "images": _images_tables,
            "features": ("keypoints", "descriptors", "global_features"),
            "matches": ("matches", "two_view_geometries"),
        }
        if what not in plans:
            raise ValueError(f"clear type {what!r} not in {set(plans)}")
        for table in plans[what]:
            self.conn.execute(f"DELETE FROM {table}")
        self.conn.commit()

    def delete_image(self, image_id: int) -> bool:
        """Remove one image and every row that references it (features,
        global feature, matches, two-view geometries). Returns False if
        the image does not exist."""
        if self.image_name(image_id) is None:
            return False
        for table in ("images", "keypoints", "descriptors",
                      "global_features"):
            self.conn.execute(
                f"DELETE FROM {table} WHERE image_id=?", (image_id,))
        for table in ("matches", "two_view_geometries"):
            pair_ids = [r[0] for r in self.conn.execute(
                f"SELECT pair_id FROM {table}")]
            drop = [(p,) for p in pair_ids
                    if image_id in images_from_pair_id(p)]
            self.conn.executemany(
                f"DELETE FROM {table} WHERE pair_id=?", drop)
        self.conn.commit()
        return True

    @staticmethod
    def merge(db1: "FeatureDatabase", db2: "FeatureDatabase",
              out: "FeatureDatabase") -> dict:
        """Merge two databases into `out` (Database::Merge used by
        RunDatabaseMerger, exe/database.cc:91-112): db1's image names
        win on collision; db2's colliding names get a '_2' suffix.
        Pair tables are remapped through the new image ids. Returns the
        {old_id: new_id} map for db2."""
        maps = []
        for tag, db in (("", db1), ("_2", db2)):
            idmap = {}
            for old_id, name in db.iter_images():
                row = db.conn.execute(
                    "SELECT width, height FROM images WHERE image_id=?",
                    (old_id,)).fetchone()
                new_name = name
                if out.image_id(new_name) is not None:
                    new_name = name + tag if tag else name
                    if out.image_id(new_name) is not None:
                        raise ValueError(
                            f"name collision on {name!r} in both inputs")
                new_id = out.add_image(new_name, row[0] or 0, row[1] or 0)
                idmap[old_id] = new_id
                kp = db.read_keypoints(old_id)
                if kp is not None:
                    out.write_keypoints(new_id, kp)
                desc = db.read_descriptors(old_id)
                if desc is not None:
                    out.write_descriptors(new_id, desc)
                gf = db.read_global_feature(old_id)
                if gf is not None:
                    out.write_global_feature(new_id, gf)
            for row in db.conn.execute(
                    "SELECT pair_id, rows, data FROM matches"):
                i1, i2 = images_from_pair_id(row[0])
                m = np.frombuffer(row[2], np.int32).reshape(row[1], 2)
                out.write_matches(idmap[i1], idmap[i2], m)
            for row in db.conn.execute(
                    "SELECT pair_id, rows, data, config, model "
                    "FROM two_view_geometries"):
                i1, i2 = images_from_pair_id(row[0])
                m = np.frombuffer(row[2], np.int32).reshape(row[1], 2)
                model = (None if not row[4]
                         else np.frombuffer(row[4], np.float64))
                out.write_two_view_geometry(idmap[i1], idmap[i2], m,
                                            config=row[3], model=model)
            maps.append(idmap)
        out.commit()
        return maps[1]
