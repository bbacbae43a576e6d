"""Hoeffding trees (VFDT) — online regressor & classifier, dependency-free.

The paper's QoS predictors (§4.1) use river's HoeffdingTreeRegressor /
HoeffdingTreeClassifier; river is not available offline so this implements
the same algorithmic family: leaves accumulate sufficient statistics per
feature bin; a leaf splits when the Hoeffding bound separates the best from
the second-best split gain with confidence 1-delta.

API mirrors river: ``learn_one(x, y)`` / ``predict_one(x)`` with x a 1-D
numpy array (the framework's feature vectors are fixed-length, Eq. 5).

Batched inference: a tree compiles lazily to a flat array-of-nodes form
(:class:`CompiledTree`) whose ``descend`` scores a whole (B, n_features)
matrix in one vectorized pass — a pure oracle-parity optimization of
``predict_one`` (identical doubles: leaf values are baked at compile time
with the same divisions ``predict_one`` performs). Every ``learn_one``
bumps a version counter (leaf means shift even without a split), so the
compiled form is invalidated and rebuilt on next use. ``stack_compiled``
concatenates many trees into one node pool with per-tree roots, so an
ensemble over m agents scores an (n·m, F) feature matrix in a single pass.
``descend_torch`` is the same walk in float32 on a torch device (the
counterpart of the reference's ``descend_jax``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.buckets import pow2_bucket


class _LeafStats:
    """Per-leaf sufficient statistics with per-feature binned sub-stats."""

    __slots__ = ("n", "s", "ss", "cls", "bins_lo", "bins_hi", "bin_n",
                 "bin_s", "bin_ss", "bin_cls", "n_feat", "n_bins", "frozen")

    def __init__(self, n_feat: int, n_bins: int = 8):
        self.n = 0
        self.s = 0.0
        self.ss = 0.0
        self.cls = np.zeros(2)  # class counts (classifier)
        self.n_feat = n_feat
        self.n_bins = n_bins
        self.bins_lo = np.full(n_feat, np.inf)
        self.bins_hi = np.full(n_feat, -np.inf)
        self.bin_n = np.zeros((n_feat, n_bins))
        self.bin_s = np.zeros((n_feat, n_bins))
        self.bin_ss = np.zeros((n_feat, n_bins))
        self.bin_cls = np.zeros((n_feat, n_bins, 2))

    def add(self, x: np.ndarray, y: float, y_cls: int | None = None):
        self.n += 1
        self.s += y
        self.ss += y * y
        if y_cls is not None:
            self.cls[y_cls] += 1
        self.bins_lo = np.minimum(self.bins_lo, x)
        self.bins_hi = np.maximum(self.bins_hi, x)
        span = np.maximum(self.bins_hi - self.bins_lo, 1e-12)
        idx = np.clip(((x - self.bins_lo) / span * self.n_bins).astype(int),
                      0, self.n_bins - 1)
        f = np.arange(self.n_feat)
        self.bin_n[f, idx] += 1
        self.bin_s[f, idx] += y
        self.bin_ss[f, idx] += y * y
        if y_cls is not None:
            self.bin_cls[f, idx, y_cls] += 1

    # -- split gain evaluation --
    def _var(self, n, s, ss):
        n = np.maximum(n, 1e-12)
        return np.maximum(ss / n - (s / n) ** 2, 0.0)

    def best_splits_regression(self):
        """Per feature: best variance-reduction split over bin boundaries."""
        total_var = self._var(self.n, self.s, self.ss)
        best_gain = np.zeros(self.n_feat)
        best_thresh = np.zeros(self.n_feat)
        cn = np.cumsum(self.bin_n, axis=1)
        cs = np.cumsum(self.bin_s, axis=1)
        css = np.cumsum(self.bin_ss, axis=1)
        for f in range(self.n_feat):
            for b in range(self.n_bins - 1):
                nl, nr = cn[f, b], self.n - cn[f, b]
                if nl < 2 or nr < 2:
                    continue
                vl = self._var(nl, cs[f, b], css[f, b])
                vr = self._var(nr, self.s - cs[f, b], self.ss - css[f, b])
                gain = total_var - (nl * vl + nr * vr) / self.n
                if gain > best_gain[f]:
                    best_gain[f] = gain
                    span = self.bins_hi[f] - self.bins_lo[f]
                    best_thresh[f] = self.bins_lo[f] + span * (b + 1) / self.n_bins
        return best_gain, best_thresh

    @staticmethod
    def _entropy(counts):
        tot = counts.sum()
        if tot <= 0:
            return 0.0
        p = counts / tot
        p = p[p > 0]
        return float(-(p * np.log2(p)).sum())

    def best_splits_classification(self):
        base = self._entropy(self.cls)
        best_gain = np.zeros(self.n_feat)
        best_thresh = np.zeros(self.n_feat)
        ccls = np.cumsum(self.bin_cls, axis=1)  # [F, bins, 2]
        for f in range(self.n_feat):
            for b in range(self.n_bins - 1):
                left = ccls[f, b]
                right = self.cls - left
                nl, nr = left.sum(), right.sum()
                if nl < 2 or nr < 2:
                    continue
                gain = base - (nl * self._entropy(left)
                               + nr * self._entropy(right)) / self.n
                if gain > best_gain[f]:
                    best_gain[f] = gain
                    span = self.bins_hi[f] - self.bins_lo[f]
                    best_thresh[f] = self.bins_lo[f] + span * (b + 1) / self.n_bins
        return best_gain, best_thresh


class _Node:
    __slots__ = ("stats", "feature", "threshold", "left", "right", "depth")

    def __init__(self, n_feat, depth):
        self.stats = _LeafStats(n_feat)
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.depth = depth

    @property
    def is_leaf(self):
        return self.feature < 0


@dataclass(frozen=True)
class CompiledTree:
    """Flat array-of-nodes form of one (or several stacked) Hoeffding trees.

    ``feature[k] < 0`` marks node ``k`` as a leaf whose prediction is
    ``value[k]``; internal nodes route ``x[feature] <= threshold`` to
    ``left`` else ``right``. ``depth`` bounds the descend iteration count.

    frozen covers the FIELDS, not the arrays: the owning tree's
    ``compiled()`` refreshes ``value`` IN PLACE after non-split
    observations (and the predictor pool does the same to its stacked
    copy), so this is a live view, not a snapshot — ``.value.copy()``
    if you need before/after comparisons.
    """
    feature: np.ndarray    # int32 [K]
    threshold: np.ndarray  # float64 [K]
    left: np.ndarray       # int32 [K]
    right: np.ndarray      # int32 [K]
    value: np.ndarray      # float64 [K]; 0.0 at internal nodes
    depth: int


def descend(tree: CompiledTree, X: np.ndarray,
            roots: np.ndarray | None = None) -> np.ndarray:
    """Vectorized tree walk: scores every row of ``X`` in one NumPy pass.

    ``roots`` gives each row its starting node (stacked multi-tree form);
    ``None`` starts every row at node 0. Rows already at a leaf keep their
    position, so ragged trees coexist in one node pool.
    """
    X = np.asarray(X, dtype=np.float64)
    n_rows = X.shape[0]
    if roots is None:
        cur = np.zeros(n_rows, dtype=np.int64)
    else:
        cur = np.asarray(roots, dtype=np.int64).copy()
    if n_rows == 0:
        return np.zeros(0, dtype=np.float64)
    rows = np.arange(n_rows)
    for _ in range(tree.depth + 1):
        f = tree.feature[cur]
        internal = f >= 0
        if not internal.any():
            break
        go_left = X[rows, np.where(internal, f, 0)] <= tree.threshold[cur]
        nxt = np.where(go_left, tree.left[cur], tree.right[cur])
        cur = np.where(internal, nxt, cur)
    return tree.value[cur]


def stack_compiled(trees: list[CompiledTree]) -> tuple[CompiledTree, np.ndarray]:
    """Concatenate compiled trees into one node pool; returns (stacked,
    root offsets) so row ``r`` of a feature matrix descends tree
    ``tree_of_row[r]`` via ``roots[tree_of_row]``."""
    sizes = np.array([len(t.feature) for t in trees], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])

    def shift(child, off):
        return np.where(child >= 0, child + off, child).astype(np.int32)

    stacked = CompiledTree(
        feature=np.concatenate([t.feature for t in trees]),
        threshold=np.concatenate([t.threshold for t in trees]),
        left=np.concatenate([shift(t.left, o)
                             for t, o in zip(trees, offsets)]),
        right=np.concatenate([shift(t.right, o)
                              for t, o in zip(trees, offsets)]),
        value=np.concatenate([t.value for t in trees]),
        depth=max(t.depth for t in trees),
    )
    return stacked, offsets


def descend_torch(tree: CompiledTree, X, roots=None,
                  device="cuda") -> np.ndarray:
    """`descend` in float32 on ``device`` (the reference's ``descend_jax``).

    Rows, the node pool and the loop depth are padded to power-of-two
    buckets exactly as the reference pads them (padded rows descend from
    node 0 and are sliced off, padded nodes are leaves, extra iterations
    leave settled rows in place), and the walk runs the bucketed depth.
    Features and thresholds are float32, as on the reference's default
    JAX configuration: against the float64 `descend` expect equal leaves
    except where a feature lands within float32 rounding of a threshold,
    where the comparison can flip and route to a different leaf.  Returns
    float64 NumPy.
    """
    import torch

    from repro_torch.utils.device import resolve_device

    dev = resolve_device(device)
    X = np.asarray(X)
    n_rows = X.shape[0]
    if roots is None:
        roots = np.zeros(n_rows, dtype=np.int32)
    nb = pow2_bucket(n_rows)
    Xp = np.zeros((nb, X.shape[1]), np.float32)
    Xp[:n_rows] = X
    rootp = np.zeros(nb, np.int64)
    rootp[:n_rows] = roots
    n_nodes = len(tree.feature)
    kb = pow2_bucket(n_nodes)
    feature = np.full(kb, -1, np.int64)            # padded nodes: leaves
    feature[:n_nodes] = tree.feature
    threshold = np.zeros(kb, np.float32)
    threshold[:n_nodes] = tree.threshold
    left = np.zeros(kb, np.int64)
    left[:n_nodes] = tree.left
    right = np.zeros(kb, np.int64)
    right[:n_nodes] = tree.right
    value = np.zeros(kb, np.float32)
    value[:n_nodes] = tree.value
    feature, threshold, left, right, value, cur, Xt = (
        torch.from_numpy(a).to(dev) for a in
        (feature, threshold, left, right, value, rootp, Xp))
    cur = descend_nodes(feature, threshold, left, right, cur, Xt,
                        pow2_bucket(tree.depth + 1, floor=4))
    return value[cur].cpu().numpy().astype(np.float64)[:n_rows]


def descend_nodes(feature, threshold, left, right, cur, X, depth: int):
    """``depth`` steps of the padded walk on device tensors: row r of ``X``
    (float32 [n, F]) moves from node ``cur[r]`` (int64) to its child while
    that node is internal (``feature >= 0``), left when the feature is
    ``<=`` the threshold; settled rows stay.  Returns the int64 nodes."""
    import torch

    for _ in range(depth):
        f = feature[cur]
        internal = f >= 0
        go_left = X.gather(1, torch.where(internal, f, 0).long()[:, None]
                           )[:, 0] <= threshold[cur]
        nxt = torch.where(go_left, left[cur], right[cur])
        cur = torch.where(internal, nxt.long(), cur)
    return cur


class _HoeffdingTreeBase:
    def __init__(self, n_features: int, *, delta: float = 1e-4,
                 grace_period: int = 40, max_depth: int = 7,
                 tie_threshold: float = 0.05, classification: bool = False):
        self.n_features = n_features
        self.delta = delta
        self.grace = grace_period
        self.max_depth = max_depth
        self.tau = tie_threshold
        self.classification = classification
        self.root = _Node(n_features, 0)
        self.n_seen = 0
        self._y_min = np.inf
        self._y_max = -np.inf
        # batched-inference cache, two-speed: structure (features/thresholds/
        # children) changes only on splits, while leaf values shift on EVERY
        # learn_one — so the flat form recompiles on _struct_version and
        # merely refreshes its value array in place on _version
        self._version = 0
        self._struct_version = 0
        self._compiled: CompiledTree | None = None
        self._compiled_version = -1
        self._compiled_struct_version = -1
        self._leaf_slots: list[tuple[int, _Node]] = []

    def _sort(self, x) -> _Node:
        node = self.root
        while not node.is_leaf:
            node = node.left if x[node.feature] <= node.threshold else node.right
        return node

    def learn_one(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        self.n_seen += 1
        self._version += 1
        self._y_min = min(self._y_min, float(y))
        self._y_max = max(self._y_max, float(y))
        node = self._sort(x)
        node.stats.add(x, float(y),
                       int(y > 0.5) if self.classification else None)
        if (node.stats.n % self.grace == 0 and node.depth < self.max_depth):
            self._try_split(node)
        return self

    def _try_split(self, node: _Node):
        st = node.stats
        if self.classification:
            gains, thresholds = st.best_splits_classification()
            value_range = 1.0  # entropy gain range for binary
        else:
            gains, thresholds = st.best_splits_regression()
            value_range = max(self._y_max - self._y_min, 1e-9) ** 2
        order = np.argsort(gains)[::-1]
        g1, g2 = gains[order[0]], gains[order[1]] if len(order) > 1 else 0.0
        eps = math.sqrt(value_range ** 2 * math.log(1.0 / self.delta)
                        / (2.0 * st.n))
        if g1 > 0 and (g1 - g2 > eps or eps < self.tau * value_range):
            f = int(order[0])
            node.feature = f
            node.threshold = float(thresholds[f])
            node.left = _Node(self.n_features, node.depth + 1)
            node.right = _Node(self.n_features, node.depth + 1)
            node.stats = None  # freed; children start fresh
            self._struct_version += 1

    # ---------------- batched inference ----------------
    def _leaf_value(self, node: _Node) -> float:
        raise NotImplementedError

    def _compile(self) -> CompiledTree:
        feats: list[int] = []
        thrs: list[float] = []
        lefts: list[int] = []
        rights: list[int] = []
        vals: list[float] = []
        leaf_slots: list[tuple[int, _Node]] = []
        depth = 0

        def emit(node: _Node) -> int:
            nonlocal depth
            k = len(feats)
            depth = max(depth, node.depth)
            feats.append(node.feature)
            thrs.append(node.threshold)
            lefts.append(-1)
            rights.append(-1)
            if node.is_leaf:
                vals.append(self._leaf_value(node))
                leaf_slots.append((k, node))
            else:
                vals.append(0.0)
                lefts[k] = emit(node.left)
                rights[k] = emit(node.right)
            return k

        emit(self.root)
        self._leaf_slots = leaf_slots
        return CompiledTree(np.asarray(feats, np.int32),
                            np.asarray(thrs, np.float64),
                            np.asarray(lefts, np.int32),
                            np.asarray(rights, np.int32),
                            np.asarray(vals, np.float64), depth)

    def compiled(self) -> CompiledTree:
        """Current flat form, refreshed lazily at two speeds: a full
        recompile only after a ``learn_one`` split changed the structure
        (O(#nodes), bounded by 2^max_depth); otherwise just the leaf-value
        array rewritten in place (O(#leaves)) — non-split observations move
        leaf means and the global fallback, never the routing arrays."""
        if (self._compiled is None
                or self._compiled_struct_version != self._struct_version):
            self._compiled = self._compile()
            self._compiled_struct_version = self._struct_version
            self._compiled_version = self._version
        elif self._compiled_version != self._version:
            value = self._compiled.value
            for k, node in self._leaf_slots:
                value[k] = self._leaf_value(node)
            self._compiled_version = self._version
        return self._compiled

    def predict_batch(self, X, backend: str = "numpy",
                      device="cuda") -> np.ndarray:
        """Score every row of ``X`` (B, n_features); matches per-row
        ``predict_one`` exactly on the NumPy backend.  ``backend="torch"``
        walks in float32 on ``device`` (`descend_torch`)."""
        X = np.asarray(X, dtype=np.float64)
        if backend == "torch":
            return descend_torch(self.compiled(), X, device=device)
        return descend(self.compiled(), X)


class HoeffdingTreeRegressor(_HoeffdingTreeBase):
    """Incremental regression tree; leaves predict their running mean."""

    def __init__(self, n_features: int, **kw):
        super().__init__(n_features, classification=False, **kw)
        self._global_s = 0.0

    def learn_one(self, x, y):
        """Absorb one (features, target) observation; may split a leaf."""
        self._global_s += float(y)
        return super().learn_one(x, y)

    def predict_one(self, x) -> float:
        """Mean of x's leaf (global mean while the leaf is still empty)."""
        if self.n_seen == 0:
            return 0.0
        node = self._sort(np.asarray(x, dtype=np.float64))
        # walk up conceptually: empty fresh leaves fall back to global mean
        if node.stats is not None and node.stats.n > 0:
            return node.stats.s / node.stats.n
        return self._global_s / self.n_seen

    def _leaf_value(self, node: _Node) -> float:
        st = node.stats
        if st is not None and st.n > 0:
            return st.s / st.n
        return self._global_s / self.n_seen if self.n_seen else 0.0


class HoeffdingTreeClassifier(_HoeffdingTreeBase):
    """Binary classifier; predict_one returns P(class=1)."""

    def __init__(self, n_features: int, **kw):
        super().__init__(n_features, classification=True, **kw)
        self._global_cls = np.zeros(2)

    def learn_one(self, x, y):
        """Absorb one observation (y thresholded at 0.5 into {0, 1})."""
        self._global_cls[int(y > 0.5)] += 1
        return super().learn_one(x, y)

    def predict_one(self, x) -> float:
        """Laplace-smoothed P(class=1) at x's leaf."""
        if self.n_seen == 0:
            return 0.5
        node = self._sort(np.asarray(x, dtype=np.float64))
        if node.stats is not None and node.stats.n > 0:
            c = node.stats.cls
            return float((c[1] + 1.0) / (c.sum() + 2.0))  # Laplace
        g = self._global_cls
        return float((g[1] + 1.0) / (g.sum() + 2.0))

    def _leaf_value(self, node: _Node) -> float:
        st = node.stats
        if st is not None and st.n > 0:
            c = st.cls
            return float((c[1] + 1.0) / (c.sum() + 2.0))
        g = self._global_cls
        # n_seen == 0 included: (0+1)/(0+2) is predict_one's 0.5 default
        return float((g[1] + 1.0) / (g.sum() + 2.0))
