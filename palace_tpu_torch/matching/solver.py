"""Conjugate-graph decomposition ("matching") solver.

The reference ships only a missing binary (``bin/matching``, the
seqGraph_phage project); its *interface* is known from
the call sites (palace:587-590, :684-688, :734-739):

    matching -g graph -r linear_out -c cycle_out [-s] -i N [-b]
             -l contigs.paths [--aggressive]

and its *output contract* from the consumers: a linear file of
tab-separated oriented-token lines and a cycle file of
(marker, path) line pairs with ``iter``/``self`` markers
(remove_cycle_dup.py:9-27, filter_result.py:125-171).

This is a from-scratch solver: **iterative mutual-best handshake
matching with chain contraction** on the conjugate graph.

Model
-----
* each segment contributes ``copy`` independent *chain instances*;
  a chain is an oriented walk and may be flipped (reverse + flip
  orientations) at any time — both representations are the same
  physical molecule;
* an oriented junction (A,oA)→(B,oB) is identical to its conjugate
  (B,~oB)→(A,~oA); its two *plugs* are the oriented nodes that leave
  each incident chain: (A,oA) and (B,~oB).  A chain end's *signature*
  is the oriented node leaving the chain at that end (back: the last
  node; front: the flipped first node).  A junction joins two chain
  ends whose signatures match its two plugs;
* junction budget = min(copy(left), copy(right)) uses of the
  canonical junction (each use consumes one end slot on each side —
  slots are implicit in the chain model: an end is used at most once);
* junction weight = read support + span_no_fastg, boosted when the
  pair is adjacent in a SPAdes path hint (-l) and, in subgraph mode
  (-b/--aggressive), when the segments are consecutive in reference
  order (the extra SEG column written by create_sub_graph.py:74-77).

Iterations (-i)
---------------
Each round snapshots, for every free chain end, its best feasible
junction weight, then merges end pairs in descending weight order
only when the junction is *mutual best* for both ends (a handshake).
Merging contracts the two chains and frees budgets/ends for the next
round, so later rounds resolve junctions that were not locally optimal
earlier (e.g. the second copy of a repeat binds its second-best
neighbour only after the best one is spent).  ``-i N`` bounds the
number of rounds: ``-i 1`` yields only the unambiguous first-round
joins; larger ``-i`` converges to a full decomposition.

Modes
-----
* ``-s`` (single/global graph): conservative — an end whose best
  weight is achieved by two *different* junctions abstains for the
  round (ambiguity may resolve later as budgets drain); protects the
  global decomposition from chimeric ties.
* default: handshake with deterministic lexicographic tie-break.
* ``-b`` (subgraph): enables the reference-order bonus column.
* ``--aggressive``: after the handshake pass, greedily applies any
  remaining feasible join in weight order even when not mutual —
  subgraphs are forced toward complete per-reference assembly.

After the rounds, each chain is closed into a cycle when a junction
with remaining budget joins its back to its own front (single-node
closures are ``self``-marked, longer ones ``iter``-marked); open
chains and fully-unplaced segments go to the linear file.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from palace_tpu_torch.io.graph_io import Graph, JuncRecord, SegRecord, parse_graph_file
from palace_tpu_torch.io.paths_io import spades_path_number_lines

HEAD, TAIL = 0, 1
_FLIP = {"+": "-", "-": "+"}


@dataclass
class MatchingOptions:
    iterations: int = 10          # -i
    single_graph: bool = False    # -s (global graph mode)
    subgraph: bool = False        # -b (per-reference subgraph mode)
    aggressive: bool = False      # --aggressive
    hints_path: Optional[str] = None  # -l contigs.paths
    hint_bonus: float = 5.0
    ref_order_bonus: float = 10.0
    #: None = auto (exact blossom matching on small graphs in default/
    #: -b/--aggressive modes; handshake for -s and bounded -i);
    #: True/False forces
    exact: Optional[bool] = None


@dataclass(frozen=True)
class Link:
    """Canonical oriented junction: the lexicographically smaller of
    the junction and its conjugate."""

    left: str
    lo: str
    right: str
    ro: str

    @staticmethod
    def canonical(left: str, lo: str, right: str, ro: str) -> "Link":
        a = (left, lo, right, ro)
        b = (right, _FLIP[ro], left, _FLIP[lo])
        return Link(*min(a, b))

    def conjugate_tuple(self) -> Tuple[str, str, str, str]:
        return (self.right, _FLIP[self.ro], self.left, _FLIP[self.lo])

    def plugs(self) -> Tuple[Tuple[str, str], Tuple[str, str]]:
        """The two oriented-node signatures this junction joins."""
        return (self.left, self.lo), (self.right, _FLIP[self.ro])

    def sort_key(self) -> Tuple[str, str, str, str]:
        return (self.left, self.lo, self.right, self.ro)


def _segment_number(name: str) -> Optional[str]:
    """SPAdes node number from ``EDGE_<n>_length_..`` names."""
    parts = name.split("_")
    return parts[1] if len(parts) > 1 else None


def _load_hint_pairs(hints_path: str, segs: Dict[str, SegRecord]) -> Set[Tuple[str, str, str, str]]:
    """Oriented (name, o, name, o) pairs adjacent in SPAdes paths."""
    num_to_name = {}
    for name in segs:
        num = _segment_number(name)
        if num is not None:
            num_to_name[num] = name
    pairs: Set[Tuple[str, str, str, str]] = set()
    try:
        rows = list(spades_path_number_lines(hints_path))
    except OSError:
        return pairs
    for row in rows:
        toks = [(num_to_name.get(t[:-1]), t[-1]) for t in row if t]
        for (n1, o1), (n2, o2) in zip(toks, toks[1:]):
            if n1 and n2:
                pairs.add((n1, o1, n2, o2))
                pairs.add((n2, _FLIP[o2], n1, _FLIP[o1]))
    return pairs


@dataclass
class _Walk:
    nodes: List[Tuple[str, str]]  # (seg, orient)
    closed: bool = False

    def tokens(self) -> List[str]:
        return [f"{seg}{o}" for seg, o in self.nodes]


@dataclass
class MatchingResult:
    linear: List[_Walk] = field(default_factory=list)
    cycles: List[_Walk] = field(default_factory=list)

    def write(self, linear_path: str | Path, cycle_path: str | Path) -> None:
        with open(linear_path, "w") as fh:
            for w in self.linear:
                fh.write("\t".join(w.tokens()) + "\n")
        with open(cycle_path, "w") as fh:
            for i, w in enumerate(self.cycles):
                marker = "self" if len(w.nodes) == 1 else f"iter {i + 1}"
                fh.write(marker + "\n")
                fh.write("\t".join(w.tokens()) + "\n")


class _Chain:
    __slots__ = ("cid", "nodes", "merged")

    def __init__(self, cid: int, nodes: List[Tuple[str, str]], merged: bool = False):
        self.cid = cid
        self.nodes = nodes
        self.merged = merged  # has this chain ever absorbed a junction?

    def flip(self) -> None:
        self.nodes = [(s, _FLIP[o]) for s, o in reversed(self.nodes)]

    def front_sig(self) -> Tuple[str, str]:
        s, o = self.nodes[0]
        return (s, _FLIP[o])

    def back_sig(self) -> Tuple[str, str]:
        return self.nodes[-1]


class _End:
    """A live chain end.  Its signature is invariant under chain flips
    and survives merges (the surviving ends of a merge keep their
    identity), so round-start state stays valid as chains contract."""

    __slots__ = ("eid", "cid", "side", "sig", "best_w", "ambiguous", "alive")

    def __init__(self, eid: int, cid: int, side: str, sig: Tuple[str, str]):
        self.eid = eid
        self.cid = cid      # current owning chain (updated on merge)
        self.side = side    # current side on that chain: 'F' or 'B'
        self.sig = sig
        self.best_w = float("-inf")
        self.ambiguous = False
        self.alive = True


class _Solver:
    def __init__(self, graph: Graph, opts: MatchingOptions):
        self.graph = graph
        self.opts = opts
        self.copies: Dict[str, int] = {
            name: max(1, seg.copy_number) for name, seg in graph.segs.items()
        }

        hints = (
            _load_hint_pairs(opts.hints_path, graph.segs) if opts.hints_path else set()
        )
        ref_order: Dict[str, int] = {}
        if opts.subgraph or opts.aggressive:
            for name, seg in graph.segs.items():
                if seg.ref_order is not None:
                    try:
                        ref_order[name] = int(float(seg.ref_order))
                    except ValueError:
                        pass

        # canonical link weights (conjugates merge) and budgets
        self.weights: Dict[Link, float] = {}
        self.budget: Dict[Link, int] = {}
        for j in graph.juncs:
            if j.left not in graph.segs or j.right not in graph.segs:
                continue
            link = Link.canonical(j.left, j.left_orient, j.right, j.right_orient)
            w = float(j.support + j.span_no_fastg)
            if (j.left, j.left_orient, j.right, j.right_orient) in hints or (
                link.left, link.lo, link.right, link.ro
            ) in hints:
                w += opts.hint_bonus
            oa = ref_order.get(j.left)
            ob = ref_order.get(j.right)
            if oa is not None and ob is not None and oa >= 0 and abs(ob - oa) == 1:
                w += opts.ref_order_bonus
            if link in self.weights:
                self.weights[link] = max(self.weights[link], w)
            else:
                self.weights[link] = w
            cap = min(self.copies.get(j.left, 1), self.copies.get(j.right, 1))
            self.budget[link] = max(self.budget.get(link, 0), cap)

        # plug-signature indexes
        self.links_by_sig: Dict[Tuple[str, str], List[Link]] = {}
        self.link_by_plugpair: Dict[Tuple[Tuple[str, str], Tuple[str, str]], Link] = {}
        for link in self.weights:
            p1, p2 = link.plugs()
            self.links_by_sig.setdefault(p1, []).append(link)
            if p2 != p1:
                self.links_by_sig.setdefault(p2, []).append(link)
            self.link_by_plugpair[tuple(sorted((p1, p2)))] = link
        for lst in self.links_by_sig.values():
            lst.sort(key=lambda l: (-self.weights[l],) + l.sort_key())

        # chain instances: one per copy, created in sorted-segment order
        self.chains: Dict[int, _Chain] = {}
        self._next_cid = 0
        for name in sorted(graph.segs):
            for _ in range(self.copies[name]):
                self.chains[self._next_cid] = _Chain(self._next_cid, [(name, "+")])
                self._next_cid += 1

    # ------------------------------------------------------------------
    def _other_plug(self, link: Link, sig: Tuple[str, str]) -> Tuple[str, str]:
        p1, p2 = link.plugs()
        return p2 if sig == p1 else p1

    def _round(self) -> bool:
        """One matching round.  Returns True if any merge happened."""
        opts = self.opts

        # --- snapshot free ends -------------------------------------
        ends: List[_End] = []
        for cid in sorted(self.chains):
            ch = self.chains[cid]
            ends.append(_End(len(ends), cid, "F", ch.front_sig()))
            ends.append(_End(len(ends), cid, "B", ch.back_sig()))
        by_sig: Dict[Tuple[str, str], List[_End]] = {}
        for e in ends:
            by_sig.setdefault(e.sig, []).append(e)
        # chain -> its two current end objects
        chain_ends: Dict[int, Dict[str, _End]] = {}
        for e in ends:
            chain_ends.setdefault(e.cid, {})[e.side] = e

        # --- per-end best feasible weight (round-start snapshot) -----
        for e in ends:
            best = float("-inf")
            best_links: Set[Link] = set()
            for link in self.links_by_sig.get(e.sig, []):
                if self.budget.get(link, 0) <= 0:
                    continue
                w = self.weights[link]
                if w < best:
                    break  # list is weight-sorted
                other = self._other_plug(link, e.sig)
                partners = by_sig.get(other, [])
                if not any(p.cid != e.cid and p is not e for p in partners):
                    continue
                if w > best:
                    best = w
                    best_links = {link}
                else:
                    best_links.add(link)
            e.best_w = best
            e.ambiguous = len(best_links) > 1

        candidates = sorted(
            (l for l in self.weights if self.budget.get(l, 0) > 0),
            key=lambda l: (-self.weights[l],) + l.sort_key(),
        )

        merged_any = False

        def _try_pairs(link: Link, require_mutual: bool) -> None:
            nonlocal merged_any
            w = self.weights[link]
            p1, p2 = link.plugs()
            while self.budget[link] > 0:
                pair = None
                for e1 in by_sig.get(p1, []):
                    if not e1.alive:
                        continue
                    if require_mutual and (
                        e1.best_w != w or (opts.single_graph and e1.ambiguous)
                    ):
                        continue
                    for e2 in by_sig.get(p2, []):
                        if not e2.alive or e2 is e1 or e2.cid == e1.cid:
                            continue
                        if require_mutual and (
                            e2.best_w != w or (opts.single_graph and e2.ambiguous)
                        ):
                            continue
                        pair = (e1, e2)
                        break
                    if pair:
                        break
                if not pair:
                    return
                self._merge(link, *pair, chain_ends)
                merged_any = True

        for link in candidates:
            _try_pairs(link, require_mutual=True)
        if opts.aggressive:
            for link in candidates:
                if self.budget.get(link, 0) > 0:
                    _try_pairs(link, require_mutual=False)
        return merged_any

    def _merge(
        self,
        link: Link,
        e1: _End,
        e2: _End,
        chain_ends: Dict[int, Dict[str, _End]],
    ) -> None:
        """Join e1's chain (oriented so e1 is its back) to e2's chain
        (oriented so e2 is its front) through ``link``."""
        c1 = self.chains[e1.cid]
        c2 = self.chains[e2.cid]
        if e1.side == "F":
            c1.flip()
        if e2.side == "B":
            c2.flip()
        new = _Chain(self._next_cid, c1.nodes + c2.nodes, merged=True)
        self._next_cid += 1
        del self.chains[c1.cid], self.chains[c2.cid]
        self.chains[new.cid] = new
        self.budget[link] -= 1
        e1.alive = False
        e2.alive = False
        # surviving ends keep identity; relocate to the merged chain
        survivors = {}
        o1 = chain_ends[c1.cid]["F" if e1.side == "B" else "B"]
        o1.cid, o1.side = new.cid, "F"
        survivors["F"] = o1
        o2 = chain_ends[c2.cid]["F" if e2.side == "B" else "B"]
        o2.cid, o2.side = new.cid, "B"
        survivors["B"] = o2
        del chain_ends[c1.cid], chain_ends[c2.cid]
        chain_ends[new.cid] = survivors

    # ------------------------------------------------------------------
    def solve(self) -> MatchingResult:
        for _ in range(max(1, self.opts.iterations)):
            if not self._round():
                break

        result = MatchingResult()

        # cycle closure: back joins front through a budgeted junction
        closed_cids: Set[int] = set()
        for cid in sorted(self.chains):
            ch = self.chains[cid]
            key = tuple(sorted((ch.back_sig(), ch.front_sig())))
            link = self.link_by_plugpair.get(key)
            if link is not None and self.budget.get(link, 0) > 0:
                self.budget[link] -= 1
                closed_cids.add(cid)
                result.cycles.append(_Walk(list(ch.nodes), closed=True))

        placed: Set[str] = {
            seg for w in result.cycles for seg, _ in w.nodes
        }
        for cid in sorted(self.chains):
            ch = self.chains[cid]
            if cid in closed_cids:
                continue
            if ch.merged:
                placed.update(seg for seg, _ in ch.nodes)

        # open chains → linear; leftover never-merged instances collapse
        # to at most one singleton per fully-unplaced segment
        emitted_singleton: Set[str] = set()
        for cid in sorted(self.chains):
            if cid in closed_cids:
                continue
            ch = self.chains[cid]
            if ch.merged:
                result.linear.append(_Walk(list(ch.nodes)))
                continue
            seg = ch.nodes[0][0]
            if seg in placed or seg in emitted_singleton:
                continue
            emitted_singleton.add(seg)
            result.linear.append(_Walk([(seg, "+")]))
        return result


def _solve_exact(solver: "_Solver") -> MatchingResult:
    """OPTIMAL decomposition via maximum-weight general matching.

    The chain model reduces exactly to a matching problem: every
    segment instance contributes two *physical end* vertices (H = 5',
    T = 3'); a junction realisation (A,oA)→(B,oB) is an edge between
    the A-instance end it leaves (T for ``+``, H for ``-``) and the
    B-instance end it enters (H for ``+``, T for ``-``), weighted like
    the handshake solver (support + span + bonuses).  Any matching is a
    valid copy-respecting path/cycle cover (instances are implicit
    H–T edges; alternating instance/junction edges have degree ≤ 2),
    junction budgets ``min(copy_l, copy_r)`` are implied by the end
    counts, and a MAXIMUM-weight matching (blossom, networkx) is the
    provably best cover — an exhaustive oracle over graphs of ≤8
    segments pins this (the greedy handshake measured ~28 % suboptimal
    on random tiny graphs).
    """
    import networkx as nx

    copies = solver.copies
    G = nx.Graph()
    for name in sorted(copies):
        for i in range(copies[name]):
            G.add_node((name, i, "H"))
            G.add_node((name, i, "T"))
    # Every edge gets a tiny epsilon so zero-weight junctions (support +
    # span == 0) still join chains, as the handshake would (its best_w
    # of 0 beats no-match).  All real weight quanta are multiples of 1
    # (int support+span, 5.0/10.0 bonuses), so eps·|matching| < 1 can
    # never trade real weight for cardinality — unlike nx's
    # maxcardinality=True, which maximises weight only AMONG
    # maximum-cardinality matchings and can sacrifice arbitrarily much
    # real weight (e.g. edges A-B w10, A-C w0, B-D w0: max-cardinality
    # picks {A-C, B-D} = 0 over {A-B} = 10).
    eps = 1.0 / (4.0 * max(1, sum(copies.values())) + 8.0)
    for link in sorted(solver.weights, key=lambda l: l.sort_key()):
        w = solver.weights[link] + eps
        a_end = "T" if link.lo == "+" else "H"
        b_end = "H" if link.ro == "+" else "T"
        for i in range(copies.get(link.left, 0)):
            for j in range(copies.get(link.right, 0)):
                u = (link.left, i, a_end)
                v = (link.right, j, b_end)
                if u == v:
                    continue  # an end cannot join itself
                if not G.has_edge(u, v) or G[u][v]["weight"] < w:
                    G.add_edge(u, v, weight=w)
    mate = {}
    for u, v in nx.max_weight_matching(G, maxcardinality=False):
        mate[u] = v
        mate[v] = u

    other = {"H": "T", "T": "H"}
    result = MatchingResult()
    visited: Set[Tuple[str, int]] = set()

    # open paths first: start at an unmatched end of a terminal instance
    for name in sorted(copies):
        for i in range(copies[name]):
            if (name, i) in visited:
                continue
            h_free = (name, i, "H") not in mate
            t_free = (name, i, "T") not in mate
            if not (h_free or t_free):
                continue
            if h_free and t_free:
                continue  # isolated — handled as singleton below
            entry = "H" if h_free else "T"
            nodes: List[Tuple[str, str]] = []
            cur = (name, i, entry)
            while cur is not None:
                nm, idx, e = cur
                visited.add((nm, idx))
                nodes.append((nm, "+" if e == "H" else "-"))
                nxt = mate.get((nm, idx, other[e]))
                cur = nxt
            result.linear.append(_Walk(nodes))
    # remaining fully-matched instances form cycles
    for name in sorted(copies):
        for i in range(copies[name]):
            if (name, i) in visited or (name, i, "H") not in mate:
                continue
            nodes = []
            cur = (name, i, "H")
            while True:
                nm, idx, e = cur
                if (nm, idx) in visited:
                    break
                visited.add((nm, idx))
                nodes.append((nm, "+" if e == "H" else "-"))
                cur = mate[(nm, idx, other[e])]
            result.cycles.append(_Walk(nodes, closed=True))

    # isolated instances: at most one singleton per fully-unplaced
    # segment (mirrors the handshake emitter)
    placed = {seg for w in result.cycles + result.linear for seg, _ in w.nodes}
    emitted: Set[str] = set()
    for name in sorted(copies):
        for i in range(copies[name]):
            if (name, i) in visited:
                continue
            if name in placed or name in emitted:
                continue
            emitted.add(name)
            result.linear.append(_Walk([(name, "+")]))
    return result


#: end-vertex count below which the exact matcher runs by default.
#: Measured (networkx blossom, dense random conjugate graphs with
#: copies ≤ 3): 600 ends 0.3 s, 2000 ends ~4 s, 4000 ends ~19 s,
#: 8000 ends ~82 s — per-reference subgraphs (where assembly quality
#: is decided) sit far below 2000; the global graph falls back to the
#: iterative handshake
EXACT_END_LIMIT = 2000

#: graphs (or junction-connected components) each solver decomposed:
#: the exact blossom matcher (networkx) or the iterative handshake
SOLVERS: Dict[str, int] = {"exact": 0, "handshake": 0}


def _connected_components(graph: Graph) -> List[Graph]:
    """Split into junction-connected components (deterministic order:
    by smallest segment name).  Components never interact — budgets,
    end slots and merge candidates are all component-local — so
    per-component solving is semantics-preserving for every mode and
    lets the exact matcher cover components that fit EXACT_END_LIMIT
    even when the whole graph does not."""
    parent: Dict[str, str] = {name: name for name in graph.segs}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for j in graph.juncs:
        if j.left in parent and j.right in parent:
            ra, rb = find(j.left), find(j.right)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
    groups: Dict[str, List[str]] = {}
    for name in graph.segs:
        groups.setdefault(find(name), []).append(name)
    out = []
    for root in sorted(groups):
        segs = {n: graph.segs[n] for n in groups[root]}
        juncs = [j for j in graph.juncs if j.left in segs]
        out.append(Graph(segs=segs, juncs=juncs))
    return out


def solve_matching(graph: Graph, opts: Optional[MatchingOptions] = None) -> MatchingResult:
    opts = opts or MatchingOptions()
    solver = _Solver(graph, opts)
    use_exact = opts.exact
    if use_exact is None:
        # auto: optimal matching wherever the graph (or each of its
        # junction-connected components) is small enough, unless the
        # caller asked for bounded-iteration semantics (-i below the
        # default).  This includes the global ``-s`` decomposition:
        # component splitting already makes cross-component chimeras
        # impossible — the property the -s abstention protects — and
        # within a component the provably max-weight matching dominates
        # the handshake.  ``--no-exact`` restores the pure
        # handshake+abstention behaviour.
        if opts.iterations >= 10:
            # per-component solving preserves every mode's semantics
            # (budgets, end slots and partners are all component-local)
            # and lets small components stay OPTIMAL even when the
            # whole graph exceeds EXACT_END_LIMIT
            comps = _connected_components(graph)
            if len(comps) > 1:
                merged = MatchingResult()
                for comp in comps:
                    r = solve_matching(comp, opts)
                    merged.linear.extend(r.linear)
                    merged.cycles.extend(r.cycles)
                return merged
        n_ends = 2 * sum(solver.copies.values())
        use_exact = opts.iterations >= 10 and n_ends <= EXACT_END_LIMIT
    if use_exact:
        try:
            result = _solve_exact(solver)
            SOLVERS["exact"] += 1
            return result
        except ImportError:  # no networkx — handshake fallback
            import logging

            logging.getLogger(__name__).warning(
                "networkx unavailable: exact blossom matcher disabled, "
                "falling back to the heuristic handshake solver "
                "(install networkx for optimal matchings)")
    SOLVERS["handshake"] += 1
    return solver.solve()


def solve_graph_file(
    graph_path: str | Path,
    linear_out: str | Path,
    cycle_out: str | Path,
    opts: Optional[MatchingOptions] = None,
) -> MatchingResult:
    """File-level entry point with the reference CLI's data contract."""
    graph = parse_graph_file(graph_path)
    result = solve_matching(graph, opts)
    result.write(linear_out, cycle_out)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI compatible with the reference call sites."""
    import argparse

    ap = argparse.ArgumentParser(prog="palace-matching")
    ap.add_argument("-g", required=True, dest="graph")
    ap.add_argument("-r", required=True, dest="linear")
    ap.add_argument("-c", required=True, dest="cycle")
    ap.add_argument("-s", action="store_true", dest="single")
    ap.add_argument("-b", action="store_true", dest="subgraph")
    ap.add_argument("-i", type=int, default=10, dest="iterations")
    ap.add_argument("-l", dest="hints", default=None)
    ap.add_argument("--aggressive", action="store_true")
    ap.add_argument("--exact", action="store_true", default=None,
                    help="force the optimal blossom matcher")
    ap.add_argument("--no-exact", action="store_false", dest="exact",
                    help="force the iterative handshake matcher")
    args = ap.parse_args(argv)
    opts = MatchingOptions(
        iterations=args.iterations,
        single_graph=args.single,
        subgraph=args.subgraph,
        aggressive=args.aggressive,
        hints_path=args.hints,
        exact=args.exact,
    )
    solve_graph_file(args.graph, args.linear, args.cycle, opts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
