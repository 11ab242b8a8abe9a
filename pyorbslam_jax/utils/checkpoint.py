"""Map checkpoint save/load (elastic restart support).

The reference has no map persistence — only final trajectory export
(System.py:114-147; SURVEY.md §5 flags checkpoint/resume as absent).
Because the map here is flat arrays + small index dicts, a checkpoint is
one compressed npz.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from pyorbslam_jax.config import SlamConfig
from pyorbslam_jax.slam.slam_map import SlamMap


def save_map(m: SlamMap, path: str) -> None:
    # the observation state IS the dense kf_obs_lm table (the native
    # core's inverse index and covisibility are derived from it on load)
    lm = m.landmarks
    ks = m.keyframes
    nl, nk = lm.n, ks.n
    parent_pairs = np.array(list(m.parent.items()), np.int64).reshape(-1, 2)
    loop_pairs = np.array(
        [(a, b) for a, bs in m.loop_edges.items() for b in bs], np.int64
    ).reshape(-1, 2)
    dead = sorted(m.dead_anchor)
    dead_parent = np.array([m.dead_anchor[k][0] for k in dead], np.int64)
    dead_Tcp = (np.stack([m.dead_anchor[k][1] for k in dead])
                if dead else np.zeros((0, 4, 4), np.float32))
    np.savez_compressed(
        path,
        n_landmarks=nl, n_keyframes=nk,
        lm_pos=lm.pos[:nl], lm_desc=lm.desc[:nl], lm_normal=lm.normal[:nl],
        lm_dmin=lm.dmin[:nl], lm_dmax=lm.dmax[:nl], lm_n_obs=lm.n_obs[:nl],
        lm_visible=lm.visible[:nl], lm_found=lm.found[:nl],
        lm_alive=lm.alive[:nl], lm_replaced=lm.replaced_by[:nl],
        kf_Tcw=ks.Tcw[:nk], kf_frame_id=ks.frame_id[:nk],
        kf_timestamp=ks.timestamp[:nk], kf_alive=ks.alive[:nk],
        kf_xy=ks.kp_xy[:nk], kf_octave=ks.kp_octave[:nk],
        kf_angle=ks.kp_angle[:nk], kf_desc=ks.kp_desc[:nk],
        kf_node=ks.kp_node[:nk], kf_valid=ks.kp_valid[:nk],
        kf_u_right=ks.u_right[:nk], kf_depth=ks.depth[:nk],
        kf_obs_lm=ks.obs_lm[:nk],
        parent=parent_pairs, loops=loop_pairs,
        dead=np.array(dead, np.int64), dead_parent=dead_parent,
        dead_Tcp=dead_Tcp,
        capacities=np.array([lm.capacity, ks.capacity, ks.n_features]),
    )


def load_map(cfg: SlamConfig, path: str) -> SlamMap:
    d = np.load(path)
    cap_lm, cap_kf, n_feat = (int(x) for x in d["capacities"])
    m = SlamMap(cfg, landmark_capacity=cap_lm, keyframe_capacity=cap_kf)
    nl = int(d["n_landmarks"])
    nk = int(d["n_keyframes"])
    lm = m.landmarks
    lm.n = nl
    lm.pos[:nl] = d["lm_pos"]
    lm.desc[:nl] = d["lm_desc"]
    lm.normal[:nl] = d["lm_normal"]
    lm.dmin[:nl] = d["lm_dmin"]
    lm.dmax[:nl] = d["lm_dmax"]
    lm.n_obs[:nl] = d["lm_n_obs"]
    lm.visible[:nl] = d["lm_visible"]
    lm.found[:nl] = d["lm_found"]
    lm.alive[:nl] = d["lm_alive"]
    lm.replaced_by[:nl] = d["lm_replaced"]
    ks = m.keyframes
    ks.n = nk
    ks.Tcw[:nk] = d["kf_Tcw"]
    ks.frame_id[:nk] = d["kf_frame_id"]
    ks.timestamp[:nk] = d["kf_timestamp"]
    ks.alive[:nk] = d["kf_alive"]
    ks.kp_xy[:nk] = d["kf_xy"]
    ks.kp_octave[:nk] = d["kf_octave"]
    ks.kp_angle[:nk] = d["kf_angle"]
    ks.kp_desc[:nk] = d["kf_desc"]
    ks.kp_node[:nk] = d["kf_node"]
    ks.kp_valid[:nk] = d["kf_valid"]
    ks.u_right[:nk] = d["kf_u_right"]
    ks.depth[:nk] = d["kf_depth"]
    ks.obs_lm[:nk] = d["kf_obs_lm"]
    for a, b in d["parent"]:
        m.parent[int(a)] = int(b)
        m.children.setdefault(int(b), set()).add(int(a))
    for a, b in d["loops"]:
        m.loop_edges.setdefault(int(a), set()).add(int(b))
    if "dead" in d:
        for k, p, T in zip(d["dead"], d["dead_parent"], d["dead_Tcp"]):
            m.dead_anchor[int(k)] = (int(p), np.asarray(T, np.float32))
    # rebuild the native inverse index + covisibility from the dense
    # observation table (recounts n_obs; saved lm_n_obs is redundant)
    m.rebuild_core()
    return m
