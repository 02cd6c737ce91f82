"""Scene graph: correspondence graph, tracks, and sparse reconstruction
(counterpart of `cvt_tpu.match.reconstruction`).

Reference: vlindex/src/base/{correspondence_graph,track,point3d,
reconstruction}.{h,cc} — COLMAP's scene model (CorrespondenceGraph
accumulates pairwise matches; Track chains observations of one 3D point
across images; Reconstruction holds cameras/images/points3D).

The graph stays on the host: `build_tracks` takes the connected
components of all match edges at once (`scipy.sparse.csgraph`) where
`cvt_tpu` runs a Python union-find; the tracks, their order and their
contents are the same, since both keep each component's observations
sorted and sort the tracks by (-length, first observation). Everything
numerical is batched on the device: multi-view DLT triangulation of ALL
tracks in one padded [T, S] batch, reprojection errors in one gather +
projection, refinement through `match.bundle.bundle_adjust`. The packing
of tracks and observations into those batches is vectorised numpy.

A `Reconstruction` resolves its device (`utils.device.resolve_device`,
the card unless `device="cpu"`) at the first method that computes
(`triangulate`, `to_ba_problem`, `bundle_adjust`, `filter_points`), so
loading, editing and saving a scene need no card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cvt_tpu_torch.match.bundle import BAProblem, bundle_adjust, rodrigues
from cvt_tpu_torch.utils.device import resolve_device


# --------------------------------------------------------------------------
# correspondence graph + tracks (host-side)
# --------------------------------------------------------------------------

class CorrespondenceGraph:
    """Accumulates pairwise feature matches; extracts transitive tracks.

    Nodes are (image_id, point2d_idx) observations; `build_tracks` takes
    the connected components of all match edges, replacing the
    reference's recursive transitive walk."""

    def __init__(self):
        self._edges: List[Tuple[int, int, np.ndarray]] = []
        self._num_obs: Dict[int, int] = {}

    def add_correspondences(self, image_id1: int, image_id2: int,
                            matches) -> None:
        """matches: [N, 2] int array of (point2d_idx1, point2d_idx2)."""
        m = np.asarray(matches, np.int64).reshape(-1, 2)
        self._edges.append((int(image_id1), int(image_id2), m))
        for iid, col in ((image_id1, 0), (image_id2, 1)):
            hi = int(m[:, col].max(initial=-1)) + 1
            self._num_obs[iid] = max(self._num_obs.get(iid, 0), hi)

    @property
    def image_ids(self) -> List[int]:
        return sorted(self._num_obs)

    def num_correspondences(self, image_id: int) -> int:
        n = 0
        for i1, i2, m in self._edges:
            if image_id in (i1, i2):
                n += m.shape[0]
        return n

    def build_tracks(self, min_length: int = 2) -> List[np.ndarray]:
        """Return tracks as [len, 2] arrays of (image_id, point2d_idx),
        each sorted, longest first (ties by first observation).

        Tracks observing the same image twice are inconsistent and
        dropped, matching COLMAP's track-merge rule."""
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        ends = [np.concatenate([np.stack([np.full(len(m), i1, np.int64),
                                          m[:, 0]], 1),
                                np.stack([np.full(len(m), i2, np.int64),
                                          m[:, 1]], 1)], 1)
                for i1, i2, m in self._edges]
        if not ends or sum(len(e) for e in ends) == 0:
            return []
        ends = np.concatenate(ends)                        # [E, 4]
        obs = ends.reshape(-1, 2)                          # [2E, 2]
        # node ids in (image_id, point2d_idx) order: one int64 key each
        lo = obs.min(0)
        span = int(obs[:, 1].max() - lo[1]) + 1
        if (int(obs[:, 0].max() - lo[0]) + 1) * span >= 2 ** 62:
            raise ValueError("image / point2d ids span too wide")
        keys, inv = np.unique((obs[:, 0] - lo[0]) * span + (obs[:, 1]
                                                            - lo[1]),
                              return_inverse=True)
        nodes = np.stack([keys // span + lo[0], keys % span + lo[1]], 1)
        inv = inv.reshape(-1, 2)
        n = len(nodes)
        graph = coo_matrix((np.ones(len(inv), np.int8),
                            (inv[:, 0], inv[:, 1])), shape=(n, n))
        _, label = connected_components(graph, directed=False)
        # each component's nodes in (image_id, point2d_idx) order
        order = np.argsort(label, kind="stable")
        lab = label[order]
        sizes = np.bincount(label)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        iids = nodes[order, 0]
        twice = (lab[1:] == lab[:-1]) & (iids[1:] == iids[:-1])
        dup = np.zeros(len(sizes), bool)
        dup[lab[1:][twice]] = True
        keep = np.nonzero((sizes >= min_length) & ~dup)[0]
        # first observation of a component = its least node id
        keep = keep[np.lexsort((order[starts[keep]], -sizes[keep]))]
        sorted_nodes = nodes[order]
        return [sorted_nodes[starts[c]:starts[c] + sizes[c]].copy()
                for c in keep]


# --------------------------------------------------------------------------
# batched geometry (device-side)
# --------------------------------------------------------------------------

def triangulate_tracks(rots, tvecs, cam_idx, uv, mask):
    """Multi-view DLT for a padded batch of tracks.

    rots [C,3,3], tvecs [C,3] world->camera; cam_idx [T,S] int,
    uv [T,S,2] normalized coords, mask [T,S] (0 pads). Returns
    (points [T,3], ok [T]) — ok requires >= 2 observations and positive
    depth in every observing camera (cheirality).

    The design A [T, 2S, 4] is built in float32, as in `cvt_tpu`; its
    smallest right singular vector is that of the 4x4 Gram matrix A^T A,
    formed in float64 (squaring A in float32 would lose the small
    singular value) and decomposed by one batched 4x4 SVD, where
    `cvt_tpu` takes the SVD of A itself.
    """
    p = torch.cat([rots, tvecs[..., None]], -1)                # [C,3,4]
    po = p[cam_idx]                                            # [T,S,3,4]
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    r1 = u * po[..., 2, :] - po[..., 0, :]                     # [T,S,4]
    r2 = v * po[..., 2, :] - po[..., 1, :]
    a = torch.cat([r1, r2], 1) * torch.cat([mask, mask], 1)[..., None]
    a64 = a.to(torch.float64)
    gram = torch.einsum("tsi,tsj->tij", a64, a64)              # [T,4,4]
    xh = torch.linalg.svd(gram)[2][..., -1, :].to(torch.float32)
    w = xh[..., 3:4]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    x = xh[..., :3] / w                                        # [T,3]
    cam_pts = (torch.sum(po[..., :3] * x[:, None, None, :], -1)
               + po[..., :, 3])
    depth_ok = torch.all(torch.where(mask > 0, cam_pts[..., 2] > 0, True),
                         1)
    ok = depth_ok & (torch.sum(mask, 1) >= 2)
    return x, ok


def _track_errors(rots, tvecs, cam_idx, uv, mask, pts):
    """Reprojection error of pts [T,3] in each observing camera [T,S]."""
    cam = (torch.sum(rots[cam_idx] * pts[:, None, None, :], -1)
           + tvecs[cam_idx])
    z = torch.where(torch.abs(cam[..., 2:]) < 1e-9, 1e-9, cam[..., 2:])
    err = torch.linalg.vector_norm(cam[..., :2] / z - uv, dim=-1)
    return torch.where(mask > 0, err, 0.0)


def reprojection_errors(poses6, points, cam_idx, pt_idx, uv, mask):
    """Per-observation reprojection error (normalized coords), batched."""
    r = rodrigues(poses6[cam_idx, :3])
    cam = (torch.sum(r * points[pt_idx][:, None, :], -1)
           + poses6[cam_idx, 3:])
    z = torch.where(torch.abs(cam[..., 2:3]) < 1e-9, 1e-9, cam[..., 2:3])
    err = torch.linalg.vector_norm(cam[..., :2] / z - uv, dim=-1)
    return torch.where(mask > 0, err, 0.0)


# --------------------------------------------------------------------------
# reconstruction container (host-side book-keeping, device-side math)
# --------------------------------------------------------------------------

@dataclass
class RegisteredImage:
    name: str
    camera_id: int
    rvec: np.ndarray                     # [3] world->camera
    tvec: np.ndarray                     # [3]
    keypoints: np.ndarray                # [K, 2] normalized camera coords


@dataclass
class Point3D:
    xyz: np.ndarray                      # [3]
    track: np.ndarray                    # [len, 2] (image_id, point2d_idx)
    error: float = 0.0


@dataclass
class Reconstruction:
    """Sparse scene: registered images + triangulated 3D points.

    Mirrors Reconstruction's public surface (reconstruction.h) at the
    scope vlindex uses: register, triangulate, filter, bundle-adjust.
    `device` (None: the card) is resolved at the first computing call."""

    images: Dict[int, RegisteredImage] = field(default_factory=dict)
    points3d: Dict[int, Point3D] = field(default_factory=dict)
    _next_pt: int = 0
    device: Optional[object] = None

    def _device(self) -> torch.device:
        return resolve_device(self.device)

    def register_image(self, image_id: int, name: str, rvec, tvec,
                       keypoints, camera_id: int = 0) -> None:
        self.images[int(image_id)] = RegisteredImage(
            name, camera_id, np.asarray(rvec, np.float64).reshape(3),
            np.asarray(tvec, np.float64).reshape(3),
            np.asarray(keypoints, np.float64).reshape(-1, 2))

    @property
    def num_points3d(self) -> int:
        return len(self.points3d)

    def _pose_arrays(self):
        ids = sorted(self.images)
        idx_of = {iid: i for i, iid in enumerate(ids)}
        poses = np.stack([np.concatenate([self.images[i].rvec,
                                          self.images[i].tvec])
                          for i in ids]).astype(np.float32)
        return ids, idx_of, poses

    def _observations(self, ids, tracks):
        """Rows (image_id, point2d_idx) of the concatenated tracks [N, 2]
        -> (camera index [N] int32, keypoint uv [N, 2] float32, registered
        [N] bool), with ids the sorted registered image ids."""
        ids_arr = np.asarray(ids, np.int64)
        cam = np.searchsorted(ids_arr, tracks[:, 0])
        cam_c = np.minimum(cam, len(ids_arr) - 1)
        reg = ids_arr[cam_c] == tracks[:, 0]
        lens = np.asarray([len(self.images[i].keypoints) for i in ids],
                          np.int64)
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
        kp = np.concatenate([self.images[i].keypoints for i in ids])
        rows = offs[cam_c[reg]] + tracks[reg, 1]
        uv = np.zeros((len(tracks), 2), np.float32)
        uv[reg] = kp[rows]
        return cam_c.astype(np.int32), uv, reg

    def triangulate(self, tracks: List[np.ndarray],
                    max_error: float = 0.01) -> int:
        """Triangulate tracks (all registered observations), keep points
        with cheirality + mean reprojection error <= max_error. Returns
        the number of points added."""
        if not tracks or not self.images:
            return 0
        ids, _, poses = self._pose_arrays()
        lens = np.asarray([len(t) for t in tracks], np.int64)
        flat = np.concatenate(tracks).astype(np.int64).reshape(-1, 2)
        cam, uv_all, reg = self._observations(ids, flat)
        owner = np.repeat(np.arange(len(tracks)), lens)
        n_reg = np.bincount(owner[reg], minlength=len(tracks))
        live = np.nonzero(n_reg >= 2)[0]
        if len(live) == 0:
            return 0
        sel = reg & (n_reg[owner] >= 2)
        t_of = np.full(len(tracks), -1, np.int64)
        t_of[live] = np.arange(len(live))
        tr = t_of[owner[sel]]                         # dense track index
        # slot of each kept row within its track
        starts = np.concatenate([[0], np.cumsum(n_reg[live])[:-1]])
        slot = np.arange(len(tr)) - starts[tr]
        tn, s = len(live), int(n_reg[live].max())
        cam_idx = np.zeros((tn, s), np.int32)
        uv = np.zeros((tn, s, 2), np.float32)
        mask = np.zeros((tn, s), np.float32)
        cam_idx[tr, slot] = cam[sel]
        uv[tr, slot] = uv_all[sel]
        mask[tr, slot] = 1.0
        dev = self._device()
        rots = rodrigues(torch.from_numpy(poses[:, :3]).to(dev))
        tvs = torch.from_numpy(poses[:, 3:]).to(dev)
        cam_t = torch.from_numpy(cam_idx).to(dev, torch.int64)
        uv_t = torch.from_numpy(uv).to(dev)
        mask_t = torch.from_numpy(mask).to(dev)
        pts, ok = triangulate_tracks(rots, tvs, cam_t, uv_t, mask_t)
        errs = _track_errors(rots, tvs, cam_t, uv_t, mask_t, pts).cpu(
        ).numpy()
        mean_err = errs.sum(1) / np.maximum(mask.sum(1), 1.0)
        pts, ok = pts.cpu().numpy(), ok.cpu().numpy()
        row_sel = np.nonzero(sel)[0]
        bounds = np.concatenate([[0], np.cumsum(n_reg[live])])
        added = 0
        for ti in range(tn):
            if ok[ti] and mean_err[ti] <= max_error:
                rows = row_sel[bounds[ti]:bounds[ti + 1]]
                self.points3d[self._next_pt] = Point3D(
                    pts[ti], flat[rows], float(mean_err[ti]))
                self._next_pt += 1
                added += 1
        return added

    def to_ba_problem(self) -> Tuple[BAProblem, List[int], List[int]]:
        """Pack the scene into a static-shape BAProblem on the scene's
        device. Returns (problem, image_ids_in_order,
        point_ids_in_order)."""
        ids, _, poses = self._pose_arrays()
        pt_ids = sorted(self.points3d)
        points = np.stack([self.points3d[p].xyz for p in pt_ids]).astype(
            np.float32)
        lens = np.asarray([len(self.points3d[p].track) for p in pt_ids],
                          np.int64)
        flat = np.concatenate([self.points3d[p].track for p in pt_ids]
                              ).astype(np.int64).reshape(-1, 2)
        cam, uv, reg = self._observations(ids, flat)
        pt_idx = np.repeat(np.arange(len(pt_ids), dtype=np.int32), lens)
        dev = self._device()

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        prob = BAProblem(
            poses=put(poses), points=put(points),
            cam_idx=put(cam[reg].astype(np.int64)),
            pt_idx=put(pt_idx[reg].astype(np.int64)),
            uv=put(uv[reg]),
            mask=torch.ones((int(reg.sum()),), dtype=torch.float32,
                            device=dev))
        return prob, ids, pt_ids

    def bundle_adjust(self, *, iters: int = 20,
                      n_fixed_poses: int = 1,
                      huber_delta: Optional[float] = None) -> float:
        """Global BA over all registered images + points; writes back."""
        if not self.points3d or not self.images:
            return 0.0          # empty scene: graceful no-op
        prob, ids, pt_ids = self.to_ba_problem()
        poses, points, cost = bundle_adjust(
            prob, iters=iters, n_fixed_poses=n_fixed_poses,
            huber_delta=huber_delta)
        poses, points = poses.cpu().numpy(), points.cpu().numpy()
        for i, iid in enumerate(ids):
            self.images[iid].rvec = poses[i, :3].astype(np.float64)
            self.images[iid].tvec = poses[i, 3:].astype(np.float64)
        for i, pid in enumerate(pt_ids):
            self.points3d[pid].xyz = points[i].astype(np.float64)
        return float(cost)

    def filter_points(self, max_error: float) -> int:
        """Drop points whose mean reprojection error exceeds max_error
        (reconstruction.cc FilterPoints3DWithLargeReprojectionError).

        The mean of each point's errors is one bincount (summed in
        float64; `cvt_tpu` takes a float32 mean per point), so a point
        whose mean lies within float32 rounding of max_error may be
        decided the other way."""
        if not self.points3d or not self.images:
            return 0            # empty scene: graceful no-op
        prob, _, pt_ids = self.to_ba_problem()
        errs = reprojection_errors(
            prob.poses, prob.points, prob.cam_idx, prob.pt_idx, prob.uv,
            prob.mask).cpu().numpy()
        pt_idx = prob.pt_idx.cpu().numpy()
        n = np.bincount(pt_idx, minlength=len(pt_ids))
        total = np.bincount(pt_idx, weights=errs, minlength=len(pt_ids))
        mean = total / np.maximum(n, 1)
        drop = np.nonzero((n > 0) & (mean > max_error))[0]
        for i in drop:
            del self.points3d[pt_ids[i]]
        return len(drop)

    # -- image management (exe/image.cc RunImageDeleter/Filterer) ---------
    def find_image_id(self, name: str) -> Optional[int]:
        for iid, im in self.images.items():
            if im.name == name:
                return iid
        return None

    def num_observations(self, image_id: int) -> int:
        """Number of 3D points observing this image."""
        return sum(1 for p in self.points3d.values()
                   if int(image_id) in p.track[:, 0])

    def deregister_image(self, image_id: int) -> bool:
        """Remove an image and prune its observations from every track
        (Reconstruction::DeRegisterImage). Tracks that fall below two
        observations lose their 3D point. Returns False if absent."""
        image_id = int(image_id)
        if image_id not in self.images:
            return False
        del self.images[image_id]
        dead = []
        for pid, p in self.points3d.items():
            keep = p.track[:, 0] != image_id
            if keep.sum() < 2:
                dead.append(pid)
            else:
                p.track = p.track[keep]
        for pid in dead:
            del self.points3d[pid]
        return True

    def filter_images(self, min_num_observations: int = 10) -> int:
        """Deregister images observed by fewer than min_num_observations
        3D points (exe/image.cc:155-203 RunImageFilterer; keypoints here
        are already in normalized camera coordinates, so only the
        observation-count criterion applies). Returns the number of
        images removed."""
        counts = {iid: 0 for iid in self.images}
        for p in self.points3d.values():
            for iid in np.unique(p.track[:, 0]):
                if int(iid) in counts:
                    counts[int(iid)] += 1
        drop = [iid for iid, c in counts.items()
                if c < min_num_observations]
        for iid in drop:
            self.deregister_image(iid)
        return len(drop)

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """Serialize to one .npz (Reconstruction::Write's binary role), in
        `cvt_tpu`'s keys: each package loads what the other saved."""
        ids = sorted(self.images)
        kp_flat = (np.concatenate([self.images[i].keypoints.reshape(-1, 2)
                                   for i in ids])
                   if ids else np.zeros((0, 2)))
        kp_len = np.asarray([len(self.images[i].keypoints) for i in ids],
                            np.int64)
        pt_ids = sorted(self.points3d)
        tr_flat = (np.concatenate([self.points3d[p].track.reshape(-1, 2)
                                   for p in pt_ids])
                   if pt_ids else np.zeros((0, 2), np.int64))
        tr_len = np.asarray([len(self.points3d[p].track) for p in pt_ids],
                            np.int64)
        np.savez(
            path,
            image_ids=np.asarray(ids, np.int64),
            names=np.asarray([self.images[i].name for i in ids]),
            camera_ids=np.asarray([self.images[i].camera_id for i in ids],
                                  np.int64),
            rvecs=(np.stack([self.images[i].rvec for i in ids])
                   if ids else np.zeros((0, 3))),
            tvecs=(np.stack([self.images[i].tvec for i in ids])
                   if ids else np.zeros((0, 3))),
            kp_flat=kp_flat, kp_len=kp_len,
            pt_ids=np.asarray(pt_ids, np.int64),
            xyz=(np.stack([self.points3d[p].xyz for p in pt_ids])
                 if pt_ids else np.zeros((0, 3))),
            errors=np.asarray([self.points3d[p].error for p in pt_ids]),
            tr_flat=np.asarray(tr_flat, np.int64), tr_len=tr_len)

    @classmethod
    def load(cls, path: str, device=None) -> "Reconstruction":
        """A scene that either package saved. `device` is kept for the
        computing methods; loading itself touches no device."""
        with np.load(path, allow_pickle=False) as f:
            # each array read once (an NpzFile reads its member anew on
            # every access)
            z = {k: f[k] for k in f.files}
        rec = cls(device=device)
        off = 0
        for i, iid in enumerate(z["image_ids"]):
            n = int(z["kp_len"][i])
            rec.register_image(
                int(iid), str(z["names"][i]), z["rvecs"][i], z["tvecs"][i],
                z["kp_flat"][off:off + n],
                camera_id=int(z["camera_ids"][i]))
            off += n
        tracks = z["tr_flat"].astype(np.int64)
        off = 0
        for i, pid in enumerate(z["pt_ids"]):
            n = int(z["tr_len"][i])
            rec.points3d[int(pid)] = Point3D(
                z["xyz"][i], tracks[off:off + n], float(z["errors"][i]))
            off += n
        rec._next_pt = int(max(rec.points3d, default=-1)) + 1
        return rec
