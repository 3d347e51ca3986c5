"""Slice/worker topology labels, and the interconnect graph over workers.

Every per-device series carries ``slice``, ``worker`` and ``topology``
(empty strings when unknown, so series identity stays stable). On an H100
node they come only from the explicit ``KTS_SLICE``, ``KTS_WORKER`` and
``KTS_TOPOLOGY`` environment variables: the reference's other sources (the
GKE TPU environment and the GCE metadata server) describe TPU slices.

The graph below is the port's copy of the reference's: which worker pairs
share which inter-node link, laid out from a ``AxBxC`` topology label
(torus) or the worker ids (ring). Its link labels follow the axis
convention (``x0``/``x1``/``y0``...). An H100 node's NVML backend labels
its links ``nvlink<N>`` — the card's links to the node's own NVSwitches,
not links between workers — so on an H100 fleet :meth:`edge_for` maps no
label to an edge, and the hub's link localizer (linkloc.py) stays inert.
"""

from __future__ import annotations

import os
from typing import Mapping


def topology_labels(environ: Mapping[str, str] | None = None) -> dict[str, str]:
    env = os.environ if environ is None else environ
    return {"slice": env.get("KTS_SLICE", ""),
            "worker": env.get("KTS_WORKER", ""),
            "topology": env.get("KTS_TOPOLOGY", "")}


# --- Interconnect graph -----------------------------------------------------
#
# The labels above identify WHERE a worker sits; the graph below models
# what CONNECTS the workers: which node pairs share which link, so the
# hub's localization pass can name a sick link instead of chasing the
# innocent neighbors that merely see its symptoms.

# Local link-label convention: axis letter + direction digit, "x0" = the
# negative-x neighbor, "x1" = positive-x, then y/z for the higher torus
# axes. Labels outside this convention (an H100's "nvlink<N>") map to no
# graph edge.
_LINK_AXES: dict[str, int] = {"x": 0, "y": 1, "z": 2}


def parse_topology(topo: str) -> tuple[int, ...] | None:
    """Dims tuple from an ``AxBxC`` topology string: "4x4x4" -> (4, 4, 4),
    "2x2" -> (2, 2). None for anything else (a product name, empty,
    malformed) — callers fall back to a ring."""
    if not topo:
        return None
    parts = topo.lower().strip().split("x")
    if len(parts) < 2:
        return None
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        return None
    if any(d <= 0 for d in dims):
        return None
    return dims


def link_name(a: str, b: str) -> str:
    """Canonical undirected link name for a worker pair: "1-2" however
    the endpoints are ordered (numeric-aware so "10" sorts after "2")."""
    try:
        lo, hi = sorted((a, b), key=int)
    except ValueError:
        lo, hi = sorted((a, b))
    return f"{lo}-{hi}"


class InterconnectGraph:
    """The slice interconnect graph over WORKER ids: nodes are workers,
    edges are the links adjacent worker pairs share.

    Built from the topology label the exporters already carry
    (``AxBxC`` -> torus grid, workers laid out row-major) when the
    worker count matches the dims product; otherwise a 1-D ring over the
    numeric worker ids (the degenerate torus — still a real adjacency,
    just without the higher axes). Non-numeric or sparse worker sets
    produce an edgeless graph: localization goes inert rather than
    guessing adjacency.

    Torus wraparound edges exist only for axis sizes > 2: on a size-2
    axis the wrap link IS the direct link (emitting it twice would
    double-count the one physical pair).
    """

    __slots__ = ("kind", "topology", "dims", "_coords", "_edges",
                 "_by_node", "_directed")

    def __init__(self, workers, topology: str = "") -> None:
        nodes = sorted({str(w) for w in workers if str(w)},
                       key=lambda w: (len(w), w))
        self.topology = topology
        dims = parse_topology(topology)
        # Contiguous canonical ids "0".."N-1": "01"-style zero padding
        # would desync the coord map's str(n) keys from the node set, so
        # it falls through to edgeless.
        contiguous = (len(nodes) >= 1
                      and {str(i) for i in range(len(nodes))}
                      == set(nodes))
        if dims is not None and contiguous and len(nodes) == _prod(dims):
            self.kind = "torus"
            self.dims = dims
        elif contiguous and len(nodes) >= 2:
            # Ring fallback: a 1-D torus over the worker ids — adjacency
            # still holds when worker numbering follows the physical
            # layout, the higher axes are simply unknown.
            self.kind = "ring"
            self.dims = (len(nodes),)
        else:
            self.kind = "none"
            self.dims = ()
        # worker id -> grid coords, row-major (last dim fastest).
        self._coords: dict[str, tuple[int, ...]] = {}
        if self.dims:
            for n in range(len(nodes)):
                coords, rem = [], n
                for size in reversed(self.dims):
                    coords.append(rem % size)
                    rem //= size
                self._coords[str(n)] = tuple(reversed(coords))
        self._edges: dict[str, tuple[str, str]] = {}
        self._by_node: dict[str, list[str]] = {w: [] for w in nodes}
        # (worker, axis, direction) -> neighbor worker, for edge_for.
        self._directed: dict[tuple[str, int, int], str] = {}
        for worker, coords in self._coords.items():
            for axis, size in enumerate(self.dims):
                for direction in (-1, +1):
                    peer = self._neighbor(coords, axis, direction, size)
                    if peer is None:
                        continue
                    self._directed[(worker, axis, direction)] = peer
                    name = link_name(worker, peer)
                    if name not in self._edges:
                        self._edges[name] = tuple(sorted(
                            (worker, peer), key=int))  # type: ignore[arg-type]
                        self._by_node[worker].append(name)
                        self._by_node[peer].append(name)

    def _neighbor(self, coords: tuple[int, ...], axis: int,
                  direction: int, size: int) -> str | None:
        if size < 2:
            return None
        at = coords[axis] + direction
        if at < 0 or at >= size:
            if size <= 2:
                return None  # size-2 wrap duplicates the direct link
            at %= size
        peer = list(coords)
        peer[axis] = at
        n = 0
        for c, s in zip(peer, self.dims):
            n = n * s + c
        return str(n)

    def nodes(self) -> list[str]:
        return list(self._by_node)

    def links(self) -> list[str]:
        return sorted(self._edges)

    def endpoints(self, link: str) -> tuple[str, str] | None:
        return self._edges.get(link)

    def links_of(self, node: str) -> list[str]:
        return list(self._by_node.get(node, ()))

    def neighbors(self, node: str) -> list[str]:
        out = []
        for name in self._by_node.get(node, ()):
            a, b = self._edges[name]
            out.append(b if a == node else a)
        return sorted(set(out), key=lambda w: (len(w), w))

    def edge_for(self, node: str, link_label: str) -> str | None:
        """The graph edge a worker's LOCAL link label ("x0", "y1", ...)
        carries traffic over, or None when the label is outside the
        axis convention (every "nvlink<N>") or points off the grid.
        This is how per-node link counters become per-edge rates: both
        endpoints of an edge map their opposing labels to the same
        canonical name."""
        if len(link_label) < 2:
            return None
        axis = _LINK_AXES.get(link_label[0].lower())
        suffix = link_label[1:]
        if axis is None or axis >= len(self.dims) or suffix not in ("0", "1"):
            return None
        direction = -1 if suffix == "0" else +1
        peer = self._directed.get((node, axis, direction))
        if peer is None:
            return None
        return link_name(node, peer)

    def describe(self) -> dict:
        return {"kind": self.kind, "topology": self.topology,
                "nodes": len(self._by_node), "links": len(self._edges)}


def _prod(dims: tuple[int, ...]) -> int:
    out = 1
    for d in dims:
        out *= d
    return out
