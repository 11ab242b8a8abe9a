// Native host-side map core: the observation index, covisibility graph,
// and BA/problem assembly for the SLAM map.
//
// The array-program analog of the reference's C++ runtime layer
// (pyORBExtractor / g2o): device math lives in JAX/XLA, while the
// pointer-chasing bookkeeping the host does per keyframe — observation
// index maintenance (MapPoint.add_observation/erase_observation,
// MapPoint.py:98-155), covisibility counting
// (KeyFrame.update_connections, KeyFrame.py:145-203), local-BA
// neighborhood gathering (Optimizer.py:211-236), and the per-frame
// local-map point gather (Tracking.update_local_keyframes/points,
// Tracking.py:392-436) — runs here instead of Python dict loops.
//
// ATTACHED-BUFFER DESIGN (single owner, no dual bookkeeping): the dense
// per-keyframe observation table (obs_lm), per-feature stereo columns
// (u_right), octaves, and the per-landmark counters (n_obs, alive,
// replaced_by, found, visible) are the SAME preallocated numpy arrays
// the Python stores use — the core holds raw pointers into them (they
// are fixed-capacity and never reallocate).  The core's private state is
// only the inverse index (landmark -> observers) and the covisibility
// weights.
//
// Exposed through a C ABI consumed via ctypes (pybind11 is not
// available in this environment).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Obs {
    int32_t kf;
    int32_t feat;
};

struct MapCore {
    int32_t kf_capacity = 0;
    int32_t n_features = 0;
    int64_t lm_capacity = 0;

    // attached numpy buffers (owned by the Python stores)
    int32_t* obs_lm = nullptr;      // [kf_capacity x n_features]
    const float* u_right = nullptr; // [kf_capacity x n_features]
    const int32_t* kp_octave = nullptr; // [kf_capacity x n_features]
    int32_t* n_obs = nullptr;       // [lm_capacity] stereo-weighted count
    uint8_t* alive = nullptr;       // [lm_capacity]
    int32_t* replaced_by = nullptr; // [lm_capacity]
    int32_t* found = nullptr;       // [lm_capacity]
    int32_t* visible = nullptr;     // [lm_capacity]

    // private inverse index + covisibility
    std::vector<std::vector<Obs>> lm_obs;                 // [lm_capacity]
    std::unordered_map<int32_t, std::unordered_map<int32_t, int32_t>> covis;
    // landmarks whose alive flag this core flipped since the last drain
    // (kills can happen deep inside erase/replace/remove paths the
    // Python layer never sees) — consumed by the device-mirror delta
    std::vector<int32_t> dirty;

    int32_t* row(int32_t kf) { return obs_lm + int64_t(kf) * n_features; }
    const float* ur_row(int32_t kf) const {
        return u_right + int64_t(kf) * n_features;
    }
    int32_t stereo_w(int32_t kf, int32_t feat) const {
        return ur_row(kf)[feat] > 0.f ? 2 : 1;
    }
};

}  // namespace

extern "C" {

void* mapcore_create(int32_t kf_capacity, int32_t n_features,
                     int64_t lm_capacity, int32_t* obs_lm,
                     const float* u_right, const int32_t* kp_octave,
                     int32_t* n_obs, uint8_t* alive, int32_t* replaced_by,
                     int32_t* found, int32_t* visible) {
    MapCore* m = new MapCore();
    m->kf_capacity = kf_capacity;
    m->n_features = n_features;
    m->lm_capacity = lm_capacity;
    m->obs_lm = obs_lm;
    m->u_right = u_right;
    m->kp_octave = kp_octave;
    m->n_obs = n_obs;
    m->alive = alive;
    m->replaced_by = replaced_by;
    m->found = found;
    m->visible = visible;
    m->lm_obs.resize(lm_capacity);
    return m;
}

void mapcore_free(void* h) { delete static_cast<MapCore*>(h); }

// Register a new keyframe's observations from the attached obs_lm row,
// bumping stereo-weighted n_obs (MapPoint.add_observation semantics:
// stereo counts 2, MapPoint.py:98-107).
void mapcore_add_keyframe(void* h, int32_t kf) {
    MapCore* m = static_cast<MapCore*>(h);
    const int32_t* r = m->row(kf);
    for (int32_t f = 0; f < m->n_features; ++f) {
        int32_t lm = r[f];
        if (lm >= 0) {
            m->lm_obs[lm].push_back({kf, f});
            m->n_obs[lm] += m->stereo_w(kf, f);
        }
    }
}

void mapcore_add_observation(void* h, int32_t lm, int32_t kf, int32_t feat) {
    MapCore* m = static_cast<MapCore*>(h);
    m->row(kf)[feat] = lm;
    m->lm_obs[lm].push_back({kf, feat});
    m->n_obs[lm] += m->stereo_w(kf, feat);
}

// Batch form for triangulation/fuse registration.
void mapcore_add_observations(void* h, const int32_t* lms,
                              const int32_t* kfs, const int32_t* feats,
                              int32_t n) {
    MapCore* m = static_cast<MapCore*>(h);
    for (int32_t i = 0; i < n; ++i) {
        m->row(kfs[i])[feats[i]] = lms[i];
        m->lm_obs[lms[i]].push_back({kfs[i], feats[i]});
        m->n_obs[lms[i]] += m->stereo_w(kfs[i], feats[i]);
    }
}

void mapcore_kill_landmark(void* h, int32_t lm) {
    MapCore* m = static_cast<MapCore*>(h);
    for (const Obs& o : m->lm_obs[lm]) {
        int32_t* r = m->row(o.kf);
        if (r[o.feat] == lm) r[o.feat] = -1;
    }
    m->lm_obs[lm].clear();
    if (m->alive[lm]) m->dirty.push_back(lm);
    m->alive[lm] = 0;
}

// Erase one observation; kills the landmark when support collapses
// (erase_observation semantics in slam_map.py: n_obs <= 2 AND a single
// remaining observer).  Returns 1 if the landmark was killed.
int32_t mapcore_erase_observation(void* h, int32_t lm, int32_t kf) {
    MapCore* m = static_cast<MapCore*>(h);
    auto& v = m->lm_obs[lm];
    for (size_t i = 0; i < v.size(); ++i) {
        if (v[i].kf == kf) {
            int32_t* r = m->row(kf);
            if (r[v[i].feat] == lm) r[v[i].feat] = -1;
            m->n_obs[lm] -= m->stereo_w(kf, v[i].feat);
            v.erase(v.begin() + i);
            break;
        }
    }
    if (m->n_obs[lm] <= 2 && v.size() <= 1) {
        mapcore_kill_landmark(h, lm);
        return 1;
    }
    return 0;
}

// MapPoint.replace (MapPoint.py:157-182): forward every observation of
// `lm` to `by` unless `by` already observes that keyframe; fold the
// found/visible counters; mark the forwarding.
void mapcore_replace_landmark(void* h, int32_t lm, int32_t by) {
    MapCore* m = static_cast<MapCore*>(h);
    if (lm == by) return;
    std::unordered_set<int32_t> by_kfs;
    for (const Obs& o : m->lm_obs[by]) by_kfs.insert(o.kf);
    for (const Obs& o : m->lm_obs[lm]) {
        int32_t* r = m->row(o.kf);
        if (!by_kfs.count(o.kf)) {
            r[o.feat] = by;
            m->lm_obs[by].push_back(o);
            m->n_obs[by] += m->stereo_w(o.kf, o.feat);
            by_kfs.insert(o.kf);
        } else if (r[o.feat] == lm) {
            r[o.feat] = -1;
        }
    }
    m->found[by] += m->found[lm];
    m->visible[by] += m->visible[lm];
    m->lm_obs[lm].clear();
    if (m->alive[lm]) m->dirty.push_back(lm);
    m->alive[lm] = 0;
    m->replaced_by[lm] = by;
}

// Drain the alive-flip log accumulated by kill/replace paths; returns
// the count written (cap-bounded; the remainder is kept for next drain).
int32_t mapcore_drain_dirty(void* h, int32_t* out, int32_t cap) {
    MapCore* m = static_cast<MapCore*>(h);
    int32_t n = std::min<int32_t>(cap, m->dirty.size());
    for (int32_t i = 0; i < n; ++i) out[i] = m->dirty[i];
    m->dirty.erase(m->dirty.begin(), m->dirty.begin() + n);
    return n;
}

// Remove a keyframe: erase its observations (with support-collapse
// kills), drop its covisibility row.  Spanning-tree bookkeeping stays in
// Python (KeyFrame.set_bad_flag intended semantics).
void mapcore_remove_keyframe(void* h, int32_t kf) {
    MapCore* m = static_cast<MapCore*>(h);
    int32_t* r = m->row(kf);
    for (int32_t f = 0; f < m->n_features; ++f) {
        if (r[f] >= 0) mapcore_erase_observation(h, r[f], kf);
    }
    auto it = m->covis.find(kf);
    if (it != m->covis.end()) {
        for (auto& kv : it->second) m->covis[kv.first].erase(kf);
        m->covis.erase(it);
    }
}

int32_t mapcore_n_observers(void* h, int32_t lm) {
    MapCore* m = static_cast<MapCore*>(h);
    return static_cast<int32_t>(m->lm_obs[lm].size());
}

int32_t mapcore_observers(void* h, int32_t lm, int32_t* out_kf,
                          int32_t* out_feat, int32_t cap) {
    MapCore* m = static_cast<MapCore*>(h);
    const auto& v = m->lm_obs[lm];
    int32_t n = std::min<int32_t>(cap, v.size());
    for (int32_t i = 0; i < n; ++i) {
        out_kf[i] = v[i].kf;
        out_feat[i] = v[i].feat;
    }
    return n;
}

// CSR batch observer dump for `n` landmarks: offsets[n+1], flat kf/feat.
// Returns total pairs written (cap-bounded).
int32_t mapcore_observers_csr(void* h, const int32_t* lm_ids, int32_t n,
                              int32_t* out_off, int32_t* out_kf,
                              int32_t* out_feat, int32_t cap) {
    MapCore* m = static_cast<MapCore*>(h);
    int32_t t = 0;
    for (int32_t i = 0; i < n; ++i) {
        out_off[i] = t;
        for (const Obs& o : m->lm_obs[lm_ids[i]]) {
            if (t >= cap) break;
            out_kf[t] = o.kf;
            out_feat[t] = o.feat;
            ++t;
        }
    }
    out_off[n] = t;
    return t;
}

// First (reference) observer per landmark; -1 when unobserved.
void mapcore_first_observers(void* h, const int32_t* lm_ids, int32_t n,
                             int32_t* out_kf, int32_t* out_feat) {
    MapCore* m = static_cast<MapCore*>(h);
    for (int32_t i = 0; i < n; ++i) {
        const auto& v = m->lm_obs[lm_ids[i]];
        out_kf[i] = v.empty() ? -1 : v[0].kf;
        out_feat[i] = v.empty() ? -1 : v[0].feat;
    }
}

// Alive landmarks with at least one observer, ids ascending.
int32_t mapcore_observed_landmarks(void* h, int32_t* out, int32_t cap,
                                   int32_t lm_hi) {
    MapCore* m = static_cast<MapCore*>(h);
    int32_t n = 0;
    int32_t hi = std::min<int64_t>(lm_hi, m->lm_capacity);
    for (int32_t p = 0; p < hi && n < cap; ++p) {
        if (m->alive[p] && !m->lm_obs[p].empty()) out[n++] = p;
    }
    return n;
}

// Recount covisibility for `kf` (KeyFrame.update_connections:145-203):
// weight = #shared landmarks, edges kept at weight >= th (or the single
// strongest).  Writes neighbors weight-desc.  Returns count; *out_parent
// gets the strongest neighbor (spanning-tree parent candidate).
int32_t mapcore_update_connections(void* h, int32_t kf, int32_t th,
                                   int32_t* out_ids, int32_t* out_w,
                                   int32_t cap, int32_t* out_parent) {
    MapCore* m = static_cast<MapCore*>(h);
    *out_parent = -1;
    std::unordered_map<int32_t, int32_t> counter;
    const int32_t* r = m->row(kf);
    for (int32_t f = 0; f < m->n_features; ++f) {
        int32_t lm = r[f];
        if (lm < 0) continue;
        for (const Obs& o : m->lm_obs[lm]) {
            if (o.kf != kf) counter[o.kf]++;
        }
    }
    if (counter.empty()) return 0;

    int32_t best_kf = -1, best_w = 0;
    std::vector<std::pair<int32_t, int32_t>> edges;  // (weight, kf)
    for (auto& kv : counter) {
        if (kv.second > best_w ||
            (kv.second == best_w && kv.first < best_kf)) {
            best_w = kv.second;
            best_kf = kv.first;
        }
        if (kv.second >= th) edges.push_back({kv.second, kv.first});
    }
    if (edges.empty()) edges.push_back({best_w, best_kf});
    std::sort(edges.begin(), edges.end(), [](auto& a, auto& b) {
        return a.first != b.first ? a.first > b.first : a.second < b.second;
    });

    auto& rowc = m->covis[kf];
    for (auto& kv : rowc) m->covis[kv.first].erase(kf);
    rowc.clear();
    int32_t n = 0;
    for (auto& e : edges) {
        rowc[e.second] = e.first;
        m->covis[e.second][kf] = e.first;
        if (n < cap) {
            out_ids[n] = e.second;
            out_w[n] = e.first;
            ++n;
        }
    }
    *out_parent = best_kf;
    return n;
}

// Ordered covisible neighbors (weight desc, id-asc tiebreak); count.
int32_t mapcore_neighbors(void* h, int32_t kf, int32_t* out_ids,
                          int32_t* out_w, int32_t cap) {
    MapCore* m = static_cast<MapCore*>(h);
    auto it = m->covis.find(kf);
    if (it == m->covis.end()) return 0;
    std::vector<std::pair<int32_t, int32_t>> edges;
    edges.reserve(it->second.size());
    for (auto& kv : it->second) edges.push_back({kv.second, kv.first});
    std::sort(edges.begin(), edges.end(), [](auto& a, auto& b) {
        return a.first != b.first ? a.first > b.first : a.second < b.second;
    });
    int32_t n = std::min<int32_t>(cap, edges.size());
    for (int32_t i = 0; i < n; ++i) {
        out_ids[i] = edges[i].second;
        out_w[i] = edges[i].first;
    }
    return n;
}

int32_t mapcore_covis_weight(void* h, int32_t a, int32_t b) {
    MapCore* m = static_cast<MapCore*>(h);
    auto it = m->covis.find(a);
    if (it == m->covis.end()) return 0;
    auto jt = it->second.find(b);
    return jt == it->second.end() ? 0 : jt->second;
}

// Dump all covisibility edges once (a < b).  Returns count.
int32_t mapcore_covis_edges(void* h, int32_t* out_a, int32_t* out_b,
                            int32_t* out_w, int32_t cap) {
    MapCore* m = static_cast<MapCore*>(h);
    int32_t n = 0;
    for (auto& kv : m->covis) {
        for (auto& e : kv.second) {
            if (kv.first < e.first && n < cap) {
                out_a[n] = kv.first;
                out_b[n] = e.first;
                out_w[n] = e.second;
                ++n;
            }
        }
    }
    return n;
}

// Per-frame local-map gather (Tracking.update_local_keyframes/points,
// Tracking.py:392-436): vote observers of the tracked landmarks, take
// the top-10 voted keyframes plus up to 10 covisible neighbors each,
// then collect those keyframes' alive landmarks (excluding the tracked
// set) up to `cap`.  Returns the number of point ids written.
int32_t mapcore_local_points(void* h, const int32_t* tracked, int32_t n_tracked,
                             int32_t* out, int32_t cap) {
    MapCore* m = static_cast<MapCore*>(h);
    std::unordered_map<int32_t, int32_t> votes;
    std::unordered_set<int32_t> tracked_set;
    tracked_set.reserve(n_tracked * 2);
    for (int32_t i = 0; i < n_tracked; ++i) {
        int32_t lm = tracked[i];
        tracked_set.insert(lm);
        for (const Obs& o : m->lm_obs[lm]) votes[o.kf]++;
    }
    if (votes.empty()) return 0;

    std::vector<std::pair<int32_t, int32_t>> ranked;  // (votes, kf)
    ranked.reserve(votes.size());
    for (auto& kv : votes) ranked.push_back({kv.second, kv.first});
    std::sort(ranked.begin(), ranked.end(), [](auto& a, auto& b) {
        return a.first != b.first ? a.first > b.first : a.second < b.second;
    });

    std::vector<int32_t> local_kfs;
    local_kfs.reserve(ranked.size() + 100);
    for (auto& r : ranked) local_kfs.push_back(r.second);
    int32_t top = std::min<int32_t>(10, ranked.size());
    int32_t nb_ids[10], nb_w[10];
    for (int32_t i = 0; i < top; ++i) {
        int32_t nn = mapcore_neighbors(h, ranked[i].second, nb_ids, nb_w, 10);
        for (int32_t j = 0; j < nn; ++j) local_kfs.push_back(nb_ids[j]);
    }

    std::unordered_set<int32_t> seen_kf;
    std::unordered_set<int32_t> seen_lm(tracked_set);
    int32_t n = 0;
    for (int32_t kf : local_kfs) {
        if (!seen_kf.insert(kf).second) continue;
        const int32_t* r = m->row(kf);
        for (int32_t f = 0; f < m->n_features; ++f) {
            int32_t lm = r[f];
            if (lm < 0 || !m->alive[lm]) continue;
            if (!seen_lm.insert(lm).second) continue;
            if (n < cap) out[n++] = lm;
        }
        if (n >= cap) break;
    }
    return n;
}

// Local-BA neighborhood (Optimizer.py:211-260 semantics as implemented
// in slam_map.local_ba): cams = [kf] + covisible neighbors (free) +
// other observers of the local points (fixed).  Outputs the cam list,
// the number of free cams, and the local point ids.
int32_t mapcore_local_ba_gather(void* h, int32_t kf, int32_t max_free,
                                int32_t max_points, int32_t max_cams,
                                int32_t* out_cams, int32_t* out_n_free,
                                int32_t* out_pnts, int32_t* out_n_pnts) {
    MapCore* m = static_cast<MapCore*>(h);
    std::vector<int32_t> ids(max_free > 0 ? max_free - 1 : 0);
    std::vector<int32_t> w(ids.size());
    int32_t nn = ids.empty() ? 0
                             : mapcore_neighbors(h, kf, ids.data(), w.data(),
                                                 ids.size());
    int32_t n_cams = 0;
    out_cams[n_cams++] = kf;
    for (int32_t i = 0; i < nn && n_cams < max_cams; ++i)
        out_cams[n_cams++] = ids[i];
    int32_t n_free = n_cams;
    *out_n_free = n_free;

    std::unordered_set<int32_t> seen_pnt;
    int32_t n_pnts = 0;
    for (int32_t c = 0; c < n_free; ++c) {
        const int32_t* r = m->row(out_cams[c]);
        for (int32_t f = 0; f < m->n_features; ++f) {
            int32_t lm = r[f];
            if (lm < 0 || !m->alive[lm]) continue;
            if (!seen_pnt.insert(lm).second) continue;
            if (n_pnts < max_points) out_pnts[n_pnts++] = lm;
        }
        if (n_pnts >= max_points) break;
    }
    *out_n_pnts = n_pnts;

    std::unordered_set<int32_t> cam_set(out_cams, out_cams + n_cams);
    for (int32_t p = 0; p < n_pnts && n_cams < max_cams; ++p) {
        for (const Obs& o : m->lm_obs[out_pnts[p]]) {
            if (!cam_set.count(o.kf)) {
                cam_set.insert(o.kf);
                out_cams[n_cams++] = o.kf;
                if (n_cams >= max_cams) break;
            }
        }
    }
    return n_cams;
}

// Assemble stereo-only BA observations for (cams x points) in problem
// order (Optimizer.py:293 stereo branch).  Returns count.
int32_t mapcore_assemble_obs(void* h, const int32_t* cam_ids, int32_t nc,
                             const int32_t* pnt_ids, int32_t np,
                             int32_t* obs_cam, int32_t* obs_pnt,
                             int32_t* obs_kf, int32_t* obs_feat,
                             int32_t cap) {
    MapCore* m = static_cast<MapCore*>(h);
    std::unordered_map<int32_t, int32_t> cam_index;
    cam_index.reserve(nc * 2);
    for (int32_t i = 0; i < nc; ++i) cam_index[cam_ids[i]] = i;
    int32_t n = 0;
    for (int32_t p = 0; p < np && n < cap; ++p) {
        for (const Obs& o : m->lm_obs[pnt_ids[p]]) {
            auto ci = cam_index.find(o.kf);
            if (ci == cam_index.end()) continue;
            if (m->ur_row(o.kf)[o.feat] <= 0.f) continue;
            if (n >= cap) break;
            obs_cam[n] = ci->second;
            obs_pnt[n] = p;
            obs_kf[n] = o.kf;
            obs_feat[n] = o.feat;
            ++n;
        }
    }
    return n;
}

// Keyframe-culling redundancy count (LocalMapping.key_frame_culling,
// LocalMapping.py:385-427): over `kf`'s observed landmarks, count those
// seen by >= 3 OTHER keyframes at the same or finer scale (octave <=
// level + 1).  Writes n_pts/n_redundant.
void mapcore_redundancy(void* h, int32_t kf, int32_t* out_n_pts,
                        int32_t* out_n_redundant) {
    MapCore* m = static_cast<MapCore*>(h);
    const int32_t* r = m->row(kf);
    const int32_t* oct = m->kp_octave + int64_t(kf) * m->n_features;
    int32_t n_pts = 0, n_red = 0;
    for (int32_t f = 0; f < m->n_features; ++f) {
        int32_t lm = r[f];
        if (lm < 0 || !m->alive[lm]) continue;
        ++n_pts;
        int32_t level = oct[f];
        int32_t better = 0;
        for (const Obs& o : m->lm_obs[lm]) {
            if (o.kf == kf) continue;
            if (m->kp_octave[int64_t(o.kf) * m->n_features + o.feat] <=
                level + 1) {
                if (++better >= 3) break;
            }
        }
        if (better >= 3) ++n_red;
    }
    *out_n_pts = n_pts;
    *out_n_redundant = n_red;
}

}  // extern "C"
