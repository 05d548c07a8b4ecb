"""Softmax hierarchy trees (WordTree), reference src/tree.c.

A tree file has one "<name> <parent_index>" line per node; siblings are
contiguous and a *group* starts whenever the parent index changes from the
previous line (read_tree, src/tree.c:83-139).  Parents always precede their
children, so ``parent[i] < i``.

Design notes:
  - the grouped softmax (``softmax_tree``) runs on the last axis with sorted
    segment reductions — group ids are contiguous and ascending by
    construction, so XLA lowers them to cheap scans, no scatter;
  - ``hierarchy_predictions`` (src/tree.c:37-51) is a sequential
    parent-product in the reference; here it is a static depth-level loop of
    gathers (max_depth steps), fully jittable;
  - greedy decode (``hierarchy_top_prediction``, src/tree.c:53-81) is
    host-side numpy — it runs per final detection, not per pixel.
"""

from __future__ import annotations

from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np


class HierarchyTree:
    """Immutable hierarchy; hashable so it can live inside frozen layer specs."""

    def __init__(
        self,
        parent: np.ndarray,
        names: tuple[str, ...] | None = None,
        leaf: np.ndarray | None = None,
    ):
        parent = np.asarray(parent, np.int32)
        n = parent.shape[0]
        if np.any(parent >= np.arange(n)):
            raise ValueError("tree file must list parents before children")
        self.n = int(n)
        self.parent = parent
        self.names = tuple(names) if names is not None else tuple(
            str(i) for i in range(n)
        )

        # group segmentation: a new group starts when the parent id changes
        # between consecutive lines (src/tree.c:105-113)
        group = np.zeros(n, np.int32)
        g = 0
        for i in range(1, n):
            if parent[i] != parent[i - 1]:
                g += 1
            group[i] = g
        self.group = group
        self.groups = int(group[-1]) + 1 if n else 0
        self.group_offset = np.zeros(self.groups, np.int32)
        self.group_size = np.zeros(self.groups, np.int32)
        for gi in range(self.groups):
            members = np.nonzero(group == gi)[0]
            self.group_offset[gi] = members[0]
            self.group_size[gi] = members.shape[0]

        # child[i] = the group index of i's children, -1 for none
        # (src/tree.c:116-118)
        child = np.full(n, -1, np.int32)
        for i in range(n):
            if parent[i] >= 0:
                child[parent[i]] = group[i]
        self.child = child

        if leaf is None:
            leaf = np.ones(n, bool)
            leaf[parent[parent >= 0]] = False
        self.leaf = np.asarray(leaf, bool)

        depth = np.zeros(n, np.int32)
        for i in range(n):
            if parent[i] >= 0:
                depth[i] = depth[parent[i]] + 1
        self.depth = depth
        self.max_depth = int(depth.max()) if n else 0

        self._hash = hash(
            (self.n, parent.tobytes(), self.leaf.tobytes(), self.names)
        )

    # hashable/eq so frozen specs holding a tree stay usable as jit statics
    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, HierarchyTree)
            and self.n == other.n
            and np.array_equal(self.parent, other.parent)
            and np.array_equal(self.leaf, other.leaf)
            and self.names == other.names
        )

    def __repr__(self) -> str:
        return f"HierarchyTree(n={self.n}, groups={self.groups}, depth={self.max_depth})"

    # ---- derived constant matrices (for vectorized hierarchical losses) ----

    @cached_property
    def path_matrix(self) -> np.ndarray:
        """[n, n] bool: path_matrix[c, k] == k is c or an ancestor of c."""
        m = np.zeros((self.n, self.n), bool)
        for c in range(self.n):
            k = c
            while k >= 0:
                m[c, k] = True
                k = int(self.parent[k])
        return m

    @cached_property
    def sibling_matrix(self) -> np.ndarray:
        """[n, n] bool: sibling_matrix[c, k] == k shares a group with c or any
        ancestor of c — the set of nodes whose deltas a truth label ``c``
        touches in the hierarchical class loss (src/region_layer.c:117-129)."""
        m = np.zeros((self.n, self.n), bool)
        for c in range(self.n):
            k = c
            while k >= 0:
                g = int(self.group[k])
                o, s = int(self.group_offset[g]), int(self.group_size[g])
                m[c, o : o + s] = True
                k = int(self.parent[k])
        return m

    def change_leaves(self, leaf_names) -> "HierarchyTree":
        """Re-mark leaves from a name list (src/tree.c:7-25)."""
        wanted = set(leaf_names)
        leaf = np.array([nm in wanted for nm in self.names], bool)
        return HierarchyTree(self.parent, self.names, leaf)


def parse_tree(lines) -> HierarchyTree:
    parents: list[int] = []
    names: list[str] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        parts = line.split()
        names.append(parts[0])
        parents.append(int(parts[1]) if len(parts) > 1 else -1)
    return HierarchyTree(np.asarray(parents, np.int32), tuple(names))


def read_tree(path: str) -> HierarchyTree:
    """Load a darknet .tree file (src/tree.c:83-139)."""
    with open(path) as f:
        return parse_tree(f)


# ---------------------------------------------------------------------------
# jittable ops
# ---------------------------------------------------------------------------


def softmax_tree(x: jax.Array, tree: HierarchyTree, temperature: float = 1.0) -> jax.Array:
    """Independent softmax within each sibling group, over the LAST axis.

    Reference: forward_softmax_layer's per-group softmax_cpu loop
    (src/softmax_layer.c:41-48).  Group ids are sorted+contiguous, so the
    segment reductions compile to scans.
    """
    if temperature != 1.0:
        x = x / temperature
    shape = x.shape
    flat = x.reshape(-1, tree.n)
    gid = jnp.asarray(tree.group)
    ngroups = tree.groups

    def row(r):
        gmax = jax.ops.segment_max(r, gid, ngroups, indices_are_sorted=True)
        e = jnp.exp(r - gmax[gid])
        gsum = jax.ops.segment_sum(e, gid, ngroups, indices_are_sorted=True)
        return e / gsum[gid]

    return jax.vmap(row)(flat).reshape(shape)


def hierarchy_predictions(
    p: jax.Array, tree: HierarchyTree, only_leaves: bool = False
) -> jax.Array:
    """Multiply each node's conditional prob by its ancestors' (src/tree.c:37-51).

    Last axis indexes tree nodes.  The reference's in-order sequential pass is
    equivalent to ``max_depth`` rounds of parent gathers because parents
    always precede (and are processed before) their children.
    """
    parent = np.where(tree.parent < 0, np.arange(tree.n), tree.parent)
    parent_j = jnp.asarray(parent)
    depth_j = jnp.asarray(tree.depth)
    for d in range(1, tree.max_depth + 1):
        p = jnp.where(depth_j == d, p * jnp.take(p, parent_j, axis=-1), p)
    if only_leaves:
        p = jnp.where(jnp.asarray(tree.leaf), p, 0.0)
    return p


def hierarchy_cross_entropy(
    logits: jax.Array, labels: jax.Array, tree: HierarchyTree
) -> jax.Array:
    """WordTree classifier loss: -sum of log conditional probability over the
    label's ancestor path.

    Matches the darknet hierarchy training target — the truth vector is 1 on
    the label and every ancestor, softmax_x_ent is taken against the grouped
    softmax (src/softmax_layer.c:53-55 with tree-structured truths).
    Returns per-example losses (…,).
    """
    p = softmax_tree(logits, tree)
    path = jnp.asarray(tree.path_matrix.astype(np.float32))[labels]
    return -jnp.sum(path * jnp.log(p + 1e-9), axis=-1)


# ---------------------------------------------------------------------------
# host-side decode helpers (numpy)
# ---------------------------------------------------------------------------


def get_hierarchy_probability(p: np.ndarray, tree: HierarchyTree, c: int) -> float:
    """Joint probability of node c = product over its ancestor path
    (src/tree.c:27-35).  ``p`` holds per-node conditional probabilities."""
    out = 1.0
    while c >= 0:
        out *= float(p[c])
        c = int(tree.parent[c])
    return out


def hierarchy_top_prediction(p: np.ndarray, tree: HierarchyTree, thresh: float) -> int:
    """Greedy root-to-leaf descent, stopping when the joint probability would
    drop below ``thresh`` (src/tree.c:53-81).  ``p`` holds conditionals."""
    prob = 1.0
    group = 0
    while True:
        o = int(tree.group_offset[group])
        s = int(tree.group_size[group])
        seg = np.asarray(p[o : o + s])
        max_i = o + int(np.argmax(seg))
        mx = float(seg.max(initial=0.0))
        if prob * mx > thresh:
            prob *= mx
            nxt = int(tree.child[max_i])
            if nxt < 0:
                return max_i
            group = nxt
        elif group == 0:
            return max_i
        else:
            return int(tree.parent[int(tree.group_offset[group])])
