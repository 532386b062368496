"""Pipeline — composition + compilation of element graphs.

The reference schedules one streaming thread per element chain and moves
buffers through pad push (SURVEY.md section 3.1).  Here a pipeline is a DAG
of elements whose `process` functions compose into ONE pure window function,
compiled by jax.jit into a single fused XLA program — the north-star fusion
goal: a 10-element 1080p graph is one kernel launch per W-frame window, not
10 thread hops.  Branching (tee) and N-input aggregation (iqa/compare, the
reference's GstVideoAggregator pattern) are plain fan-out/fan-in in the DAG;
the aggregator's clock-synchronization barrier (SURVEY.md section 3.4)
becomes structural: every branch advances in lockstep inside one program.

`parse_launch` maps gst-launch-1.0 syntax onto this composition, including
named elements and branch links:

    parse_launch("videotestsrc name=src ! burn ! cmp.  "
                 "src. ! cmp.  compare name=cmp method=ssim ! fakesink")
"""

from __future__ import annotations

import shlex
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gstbad.core.bus import Bus, Message
from gstbad.core.element import Element
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import make
from gstbad.core.spec import MediaSpec, SpecError


class Node:
    def __init__(self, element: Element, name: Optional[str] = None):
        self.element = element
        self.name = name
        self.inputs: List["Node"] = []
        self.spec: Optional[MediaSpec] = None

    def __repr__(self):
        return f"<node {self.name or self.element.NAME}>"


def _split_trimmed(nb: FrameBatch) -> List[FrameBatch]:
    """Apply FrameBatch.trim host-side (the gst_audio_buffer_clip cut):
    blocks with head/tail trims split out as their own shorter batches;
    untrimmed runs stay stacked.  PTS are the element's responsibility
    (the gating element already stamps the clipped-buffer PTS)."""
    tr = nb.trim
    if tr is None:
        return [nb]
    tr = np.asarray(tr)
    data = nb.data
    if (isinstance(data, dict) or getattr(data, "ndim", 0) < 2
            or not np.any(tr)):
        return [nb.replace(trim=None)]
    b, s = data.shape[0], data.shape[1]
    out: List[FrameBatch] = []
    i = 0
    while i < b:
        if tr[i].any():
            h, t = int(tr[i, 0]), int(tr[i, 1])
            h = min(max(h, 0), s)
            t = min(max(t, 0), s - h)
            if s - h - t > 0:
                out.append(FrameBatch(
                    data=data[i:i + 1, h:s - t], pts=nb.pts[i:i + 1],
                    flags=nb.flags[i:i + 1], valid=nb.valid[i:i + 1]))
            i += 1
        else:
            j = i
            while j < b and not tr[j].any():
                j += 1
            out.append(FrameBatch(
                data=data[i:j], pts=nb.pts[i:j], flags=nb.flags[i:j],
                valid=nb.valid[i:j]))
            i = j
    return out


class Pipeline:
    def __init__(self, elements: Sequence[Element] = (),
                 nodes: Optional[List[Node]] = None):
        if nodes is None:
            if not elements:
                raise ValueError("empty pipeline")
            nodes = []
            prev = None
            for el in elements:
                n = Node(el)
                if prev is not None:
                    n.inputs.append(prev)
                nodes.append(n)
                prev = n
        self.nodes = nodes
        self.bus = Bus()
        self._step = None
        self._states = None
        self._window = None
        self._in_spec: Optional[MediaSpec] = None
        self._order: Optional[List[Node]] = None

    # -- convenience views --------------------------------------------------
    @property
    def elements(self) -> List[Element]:
        return [n.element for n in self.nodes]

    @property
    def specs(self) -> List[MediaSpec]:
        return [n.spec for n in (self._order or self.nodes)]

    def get_by_name(self, name: str) -> Element:
        for n in self.nodes:
            if n.name == name:
                return n.element
        raise KeyError(name)

    # -- graph structure -----------------------------------------------------
    def _toposort(self) -> List[Node]:
        order: List[Node] = []
        seen: Dict[int, int] = {}

        def visit(n: Node):
            state = seen.get(id(n), 0)
            if state == 1:
                raise SpecError("pipeline graph has a cycle")
            if state == 2:
                return
            seen[id(n)] = 1
            for i in n.inputs:
                visit(i)
            seen[id(n)] = 2
            order.append(n)

        for n in self.nodes:
            visit(n)
        return order

    def _leaves(self) -> List[Node]:
        consumed = {id(i) for n in self.nodes for i in n.inputs}
        return [n for n in self.nodes if id(n) not in consumed]

    # -- negotiation ---------------------------------------------------------
    def negotiate(self, in_spec: Optional[MediaSpec] = None) -> MediaSpec:
        """Spec fixation in topological order (caps negotiation analog)."""
        if in_spec is not None or not hasattr(self, "_in_spec"):
            self._in_spec = in_spec
        self._order = self._toposort()
        for n in self._order:
            el = n.element
            if el.KIND in ("source", "host-source"):
                n.spec = el.set_info(in_spec or MediaSpec())
            elif not n.inputs:
                if in_spec is None:
                    raise SpecError(
                        f"{el.NAME}: no source and no input spec")
                n.spec = el.set_info(in_spec)
            elif len(n.inputs) == 1:
                n.spec = el.set_info(n.inputs[0].spec)
            else:
                n.spec = el.set_info([i.spec for i in n.inputs])
        return self._leaves()[-1].spec

    @property
    def out_spec(self) -> MediaSpec:
        return self._leaves()[-1].spec

    # -- compilation ---------------------------------------------------------
    def compile(self, window: int, in_spec: Optional[MediaSpec] = None,
                jit: bool = True, donate_state: bool = True,
                out_shardings=None, mesh=None,
                taps: Sequence[str] = (), fuse_luts: bool = True):
        """Build the fused window function over the whole DAG.

        step(params, states, in_batch_or_None)
            -> (states, leaf_batches, messages)

        taps: element/node names whose intermediate output batches should be
        materialized (SURVEY.md §7 hard-part 5 — fusion vs verifiability).
        Tapped values are appended to leaf_batches as extra XLA outputs: the
        fused program's numerics are unchanged (XLA is deterministic per
        compilation; the tap only adds an output buffer).  Retrieve them
        with `taps_of(leaf_batches)` -> {name: FrameBatch}.
        """
        if self._order is None or (in_spec is not None):
            self.negotiate(in_spec)
        self._window = window
        order = self._order
        leaves = self._leaves()

        # HOST elements (host_process sinks/taps) receive the batch flowing
        # through THEIR node, not every leaf's (a tee fan-out must not feed
        # branch A's frames to branch B's filesink).  Host nodes that are
        # leaves reuse the leaf output; mid-graph host nodes (e.g. accurip)
        # get their node value appended after the leaves.
        host_nodes = [n for n in order if getattr(n.element, "HOST", False)]
        leaf_index = {id(n): i for i, n in enumerate(leaves)}
        extra_nodes = [n for n in host_nodes if id(n) not in leaf_index]
        self._host_route = []
        for n in host_nodes:
            if id(n) in leaf_index:
                self._host_route.append((n.element, leaf_index[id(n)]))
            else:
                self._host_route.append(
                    (n.element, len(leaves) + extra_nodes.index(n)))

        # debug taps: materialize named nodes' outputs as extra leaf slots
        def node_named(name: str) -> Node:
            for n in order:
                if n.name == name or n.element.NAME == name:
                    return n
            raise KeyError(f"tap: no element named {name!r}")

        tap_nodes = [node_named(t) for t in taps]
        tap_extra: List[Node] = []
        self._tap_route = {}
        for t, n in zip(taps, tap_nodes):
            if id(n) in leaf_index:
                self._tap_route[t] = leaf_index[id(n)]
            elif n in extra_nodes:
                self._tap_route[t] = len(leaves) + extra_nodes.index(n)
            else:
                if n not in tap_extra:
                    tap_extra.append(n)
                self._tap_route[t] = (len(leaves) + len(extra_nodes)
                                      + tap_extra.index(n))

        # Table-state fusion (core/tablefuse.py, Element.byte_map/word_map/
        # table_head/index_stencil/table_tail): runs of per-pixel elements
        # get their work COMPOSED into 256-entry table math instead of each
        # traversing the frame.  A run extends only through nodes whose
        # sole consumer is the next run member and that nothing else
        # observes (leaves, host sinks, taps); everything else flushes.
        consumers: Dict[int, List[Node]] = {}
        for n in order:
            for i in n.inputs:
                consumers.setdefault(id(i), []).append(n)
        protected = ({id(n) for n in leaves} | {id(n) for n in extra_nodes}
                     | {id(n) for n in tap_nodes})

        def step(params: List[Dict[str, Any]], states: List[Any],
                 in_batch: Optional[FrameBatch]):
            from gstbad.core import tablefuse

            new_states = list(states)
            messages: Dict[str, Dict[str, Any]] = {}
            values: Dict[int, FrameBatch] = {}
            # id(node) -> TableChain whose symbolic value is node's output
            chains: Dict[int, tablefuse.TableChain] = {}

            def flush(nid: int) -> None:
                chain = chains.pop(nid)
                if len(chain.members) == 1 and not chain._time_invariant():
                    # a lone fused node keeps its own (cheaper) process —
                    # EXCEPT when the chain is time-invariant: the
                    # one-frame-then-broadcast materialization beats any
                    # per-frame process (static source + static tables)
                    si, el = chain.members[0]
                    new_states[si], val = el.process(params[si], states[si],
                                                     chain.src_batch)
                else:
                    val = chain.materialize()
                values[nid] = val

            def value_of(node: Node) -> FrameBatch:
                if id(node) in chains:
                    flush(id(node))
                return values[id(node)]

            def try_absorb(chain, el, p) -> bool:
                bm = el.byte_map(p)
                if bm is not None:
                    chain.absorb_byte_map(bm, el.byte_map_kinds())
                    return True
                head = el.table_head(p)
                if head is not None and chain.absorb_head(*head):
                    return True
                wm = el.word_map(p)
                if wm is not None and chain.absorb_word_map(wm):
                    return True
                st = el.index_stencil(p)
                if st is not None and chain.absorb_index_stencil(
                        st[0], st[1], p, st[2] if len(st) > 2 else None):
                    return True
                return False

            feed_idx = 0
            for si, n in enumerate(order):
                el = n.element
                if fuse_luts and len(n.inputs) == 1 and el.KIND != "source":
                    inp = n.inputs[0]
                    chain = None
                    popped_live = False
                    if (id(inp) in chains and id(inp) not in protected
                            and consumers.get(id(inp)) == [n]):
                        chain = chains.pop(id(inp))
                        popped_live = True
                    elif el.FUSES:
                        chain = tablefuse.start_chain(value_of(inp))
                    if chain is not None:
                        tail = el.table_tail(params[si], states[si], chain,
                                             chain.src_batch)
                        if tail is not None:
                            new_states[si], data = tail
                            # a tail may return a full FrameBatch (to keep
                            # a word twin attached for the sink)
                            values[id(n)] = (
                                data if isinstance(data, FrameBatch)
                                else chain.src_batch.with_data(data))
                            continue
                        if try_absorb(chain, el, params[si]):
                            chain.members.append((si, el))
                            new_states[si] = states[si]
                            chains[id(n)] = chain
                            continue
                        if popped_live:
                            chains[id(inp)] = chain
                            flush(id(inp))
                if el.KIND == "source":
                    out = el.generate(params[si], states[si], window)
                else:
                    if not n.inputs:
                        # multiple host-sources feed as a list, one entry
                        # per input-less node in traversal order (matching
                        # run()'s pull order); a single batch broadcasts
                        if isinstance(in_batch, (list, tuple)):
                            batch = in_batch[feed_idx]
                            feed_idx += 1
                        else:
                            batch = in_batch
                    elif len(n.inputs) == 1:
                        batch = value_of(n.inputs[0])
                    else:
                        batch = [value_of(i) for i in n.inputs]
                    out = el.process(params[si], states[si], batch)
                if len(out) == 3:
                    st, val, msgs = out
                    for name, fields in msgs.items():
                        messages[f"{el.NAME}:{name}"] = fields
                else:
                    st, val = out
                new_states[si] = st
                values[id(n)] = val
            leaf_out = ([value_of(n) for n in leaves]
                        + [value_of(n) for n in extra_nodes]
                        + [value_of(n) for n in tap_extra])
            return new_states, leaf_out, messages

        if mesh is not None and out_shardings is None:
            # source-driven multi-chip: shard every leaf batch dp over
            # frames, sp over rows (parallel/mesh.py placement).  The
            # sharding pytree is derived from the traced output shapes so
            # optional FrameBatch fields (word/word_base/trim) get
            # divisibility-checked specs instead of a static mismatch.
            from jax.sharding import NamedSharding, PartitionSpec as P

            dp_n = mesh.shape.get("dp", 1)
            sp_n = mesh.shape.get("sp", 1)
            states0 = self._states or [n.element.init_state(window)
                                       for n in order]
            out_abs = jax.eval_shape(
                step, [n.element.dynamic_params() for n in order],
                states0, None)

            def _sh(x):
                if getattr(x, "ndim", 0) == 0:
                    return NamedSharding(mesh, P())
                spec = ["dp" if x.shape[0] % dp_n == 0 else None]
                if x.ndim >= 2:
                    spec.append("sp" if x.shape[1] % sp_n == 0 else None)
                return NamedSharding(mesh, P(*spec))

            out_shardings = (
                None, jax.tree_util.tree_map(_sh, out_abs[1]), None)
        if jit:
            donate = (1,) if donate_state else ()
            step = jax.jit(step, donate_argnums=donate,
                           out_shardings=out_shardings)
        self._step = step
        self._mesh = mesh
        if self._states is None:
            self._states = [n.element.init_state(window) for n in order]
        return step

    def taps_of(self, leaf_batches) -> Dict[str, FrameBatch]:
        """Extract tapped intermediates from a step's leaf_batches."""
        return {name: leaf_batches[i]
                for name, i in getattr(self, "_tap_route", {}).items()}

    def init_states(self, window: int):
        order = self._order or self._toposort()
        return [n.element.init_state(window) for n in order]

    def params(self) -> List[Dict[str, Any]]:
        order = self._order or self._toposort()
        return [n.element.dynamic_params() for n in order]

    # -- host runner ----------------------------------------------------------
    def run(self, n_frames: int = 0, inputs: Optional[FrameBatch] = None,
            window: Optional[int] = None):
        """Drive the pipeline; returns the valid output frames per window
        (single leaf) or {leaf_index: [batches]} for multi-leaf graphs.

        Invalid (masked-out) frames are compacted away host-side between
        windows, the analog of GST_BASE_TRANSFORM_FLOW_DROPPED.
        """
        if inputs is not None:
            window = window or inputs.batch
        window = window or self._window or n_frames
        if not window:
            raise ValueError("run() needs a window size (or inputs/n_frames)")
        if self._step is None or window != self._window:
            self.compile(window)
        order = self._order
        states = self._states
        params = self.params()
        leaves = self._leaves()
        outs: Dict[int, List[FrameBatch]] = {i: [] for i in
                                             range(len(leaves))}
        # Windows are pulled LAZILY and interleaved with execution so a
        # live host-source's ring backpressure applies end-to-end (no
        # unbounded pre-pull) and output is emitted incrementally.  A pull
        # timeout is a recoverable stall: already-processed output is kept,
        # a warning is posted, and the run ends cleanly.
        def window_iter():
            if inputs is not None:
                for i in range(0, inputs.batch, window):
                    yield jax.tree_util.tree_map(
                        lambda x, i=i: x[i:i + window], inputs)
                return
            host_sources = [n.element for n in order
                            if n.element.KIND == "host-source"]
            if host_sources:
                while True:
                    try:
                        ws = [hs.pull_window(window) for hs in host_sources]
                    except TimeoutError as e:
                        self.bus.post(Message(
                            "pipeline", "stall", 0,
                            {"reason": f"source pull timed out: {e}"}))
                        return
                    if any(x is None for x in ws):
                        return
                    yield ws if len(ws) > 1 else ws[0]
            else:
                for _ in range(-(-n_frames // window)):
                    yield None

        windows = window_iter()
        has_controls = any(n.element._controls for n in order)
        src_spec = order[0].spec
        dur = (src_spec.frame_duration_ns if src_spec
               and src_spec.kind == "video" else int(1e9 / 30))
        frame_counter = 0
        for w in windows:
            if has_controls:
                # stream-time sync (gst_object_sync_values analog)
                if w is not None:
                    pts = np.asarray((w[0] if isinstance(w, (list, tuple))
                                      else w).pts)
                else:
                    pts = (frame_counter
                           + np.arange(window, dtype=np.int64)) * dur
                params = [n.element.params_for_pts(pts)
                          if n.element._controls
                          else n.element.dynamic_params() for n in order]
                frame_counter += window
            states, leaf_batches, messages = self._step(params, states, w)
            self._drain_messages(leaf_batches[len(leaves) - 1], messages)
            np_batches: Dict[int, Optional[FrameBatch]] = {}

            def compacted(oi: int) -> List[FrameBatch]:
                if oi not in np_batches:
                    np_batch = leaf_batches[oi].to_numpy()
                    # a word-keeping sink (fakesink over a packed twin)
                    # returns the i32 word view; restore the byte view
                    # host-side (free bitcast — identical memory bytes)
                    d = np_batch.data
                    if (np_batch.word is not None
                            and not isinstance(d, dict)
                            and d.dtype == np.int32 and d.ndim == 3
                            and d.shape == np_batch.word.shape):
                        np_batch = np_batch.replace(
                            data=np.ascontiguousarray(d).view(np.uint8)
                            .reshape(d.shape + (4,)), word=None,
                            word_base=None)
                    mask = np.asarray(np_batch.valid)
                    if not mask.all():
                        if not mask.any():
                            np_batch = None
                        else:
                            np_batch = jax.tree_util.tree_map(
                                lambda x: x[mask]
                                if getattr(x, "ndim", 0) >= 1
                                and x.shape[0] == mask.shape[0] else x,
                                np_batch)
                    np_batches[oi] = (_split_trimmed(np_batch)
                                      if np_batch is not None else [])
                return np_batches[oi]

            for li in range(len(leaves)):
                outs[li].extend(compacted(li))
            # each HOST element sees only its own node's stream
            for el, oi in self._host_route:
                for np_batch in compacted(oi):
                    el.host_process(np_batch, self.bus)
        self._states = states
        if len(leaves) == 1:
            return outs[0]
        return outs

    def send_eos(self):
        """EOS analog: drain elements that hold queued frames (the
        fieldanalysis/ivtc flush path, gstfieldanalysis.c:744-781).

        Returns the drained frames per element name.  Drained frames are
        also run through any HOST sinks; downstream re-processing of drained
        frames is not propagated (matching a tail-position analyzer).
        """
        drained = {}
        order = self._order or self._toposort()
        if self._states is None:
            return drained
        # drained frames flow to host elements DOWNSTREAM of the drained
        # node only (a tee branch's flush must not hit the other branch)
        children: Dict[int, List[Node]] = {}
        for n in order:
            for i in n.inputs:
                children.setdefault(id(i), []).append(n)

        def downstream_hosts(node: Node) -> List[Element]:
            out, stack, seen = [], [node], set()
            while stack:
                cur = stack.pop()
                for ch in children.get(id(cur), []):
                    if id(ch) in seen:
                        continue
                    seen.add(id(ch))
                    if getattr(ch.element, "HOST", False):
                        out.append(ch.element)
                    stack.append(ch)
            return out

        for idx, n in enumerate(order):
            el = n.element
            if not hasattr(el, "drain"):
                continue
            st, batch = el.drain(self._states[idx])
            self._states[idx] = st
            if batch is not None:
                np_batch = batch.to_numpy()
                for h in downstream_hosts(n):
                    h.host_process(np_batch, self.bus)
                drained.setdefault(el.NAME, []).append(np_batch)
        return drained

    def close(self) -> None:
        """Tear down to NULL (gst_element_set_state(NULL) analog): every
        element with a close() hook flushes/releases its host resources
        (file sinks write their container tails, rings unmap, ...)."""
        for n in self.nodes:
            if hasattr(n.element, "close"):
                n.element.close()

    # -- runtime graph editing (insertbin analog) ------------------------------
    # gst-libs/gst/insertbin/gstinsertbin.c exposes insert_before/after and
    # remove on a RUNNING bin, draining pads around the edit.  Here the graph
    # is a compiled program, so an edit = mutate the DAG, renegotiate, and
    # recompile on the next run — with live element states carried across by
    # node identity (Element.carry_state handles shape migrations).  The
    # same machinery makes STATIC properties live-settable
    # (set_static_property), e.g. pitch tempo mid-stream (gstpitch.cc:248).

    def _node_named(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name or n.element.NAME == name:
                return n
        raise KeyError(f"no element named {name!r}")

    def _snapshot_states(self) -> Dict[int, Any]:
        if self._states is None or self._order is None:
            return {}
        return {id(n): s for n, s in zip(self._order, self._states)}

    def _rebuild(self, saved: Dict[int, Any]) -> None:
        self._step = None
        self._order = None
        self.negotiate(self._in_spec)
        if saved and self._window:
            self._states = [
                n.element.carry_state(saved[id(n)], self._window)
                if id(n) in saved else n.element.init_state(self._window)
                for n in self._order]
        else:
            self._states = None

    def insert_after(self, name: str, element: Element,
                     new_name: Optional[str] = None) -> None:
        """Insert `element` after node `name`; every consumer of that node
        (all tee branches) is rerouted through the new element."""
        saved = self._snapshot_states()
        anchor = self._node_named(name)
        node = Node(element, new_name)
        node.inputs.append(anchor)
        for n in self.nodes:
            if n is not node:
                n.inputs = [node if i is anchor else i for i in n.inputs]
        self.nodes.insert(self.nodes.index(anchor) + 1, node)
        self._rebuild(saved)

    def insert_before(self, name: str, element: Element,
                      new_name: Optional[str] = None) -> None:
        """Insert `element` on every input edge of node `name` (the linear
        chain's single edge in the common case)."""
        saved = self._snapshot_states()
        anchor = self._node_named(name)
        node = Node(element, new_name)
        node.inputs = list(anchor.inputs)
        anchor.inputs = [node]
        self.nodes.insert(self.nodes.index(anchor), node)
        self._rebuild(saved)

    def remove(self, name: str) -> Element:
        """Remove node `name`, splicing its (single) input to its
        consumers; its carried state is dropped, everyone else's kept."""
        saved = self._snapshot_states()
        node = self._node_named(name)
        if len(node.inputs) > 1:
            raise SpecError(
                f"remove({name!r}): aggregation points cannot be spliced "
                "out (insertbin handles linear segments)")
        repl = node.inputs[0] if node.inputs else None
        for n in self.nodes:
            if node in n.inputs:
                n.inputs = [x for x in
                            (repl if i is node else i for i in n.inputs)
                            if x is not None]
        self.nodes.remove(node)
        saved.pop(id(node), None)
        self._rebuild(saved)
        return node.element

    def set_static_property(self, name: str, prop: str, value) -> None:
        """Change a STATIC (compile-baked) property on a running pipeline:
        renegotiate + recompile, carrying every element's state across
        (shape-affected states go through the element's migrate_state)."""
        saved = self._snapshot_states()
        self._node_named(name).element.set_property(prop, value)
        self._rebuild(saved)

    # -- checkpoint/resume ----------------------------------------------------
    # SURVEY.md section 5.4: element state is an explicit pytree carry, so
    # checkpointing is serializing the carry + stream position — something
    # the reference cannot do at all.
    def save_checkpoint(self, path: str) -> None:
        import pickle
        if self._states is None:
            raise SpecError("nothing to checkpoint; run a window first")
        states_np = jax.tree_util.tree_map(np.asarray, self._states)
        # host-source stream positions (file offsets / frame indices) via
        # the save_position hook, so resume does not replay the input; live
        # sources (shmsrc, ipcpipelinesrc) have no position and are skipped
        positions = {i: n.element.save_position()
                     for i, n in enumerate(self.nodes)
                     if hasattr(n.element, "save_position")}
        unresumable = [n.element.NAME for n in self.nodes
                       if n.element.KIND == "host-source"
                       and not hasattr(n.element, "save_position")]
        with open(path, "wb") as f:
            pickle.dump({"states": states_np, "window": self._window,
                         "positions": positions,
                         "unresumable_sources": unresumable}, f)

    def load_checkpoint(self, path: str) -> None:
        import pickle
        with open(path, "rb") as f:
            ck = pickle.load(f)
        if self._order is None:
            self.negotiate()
        self._states = jax.tree_util.tree_map(jnp.asarray, ck["states"])
        for i, v in ck.get("positions", {}).items():
            self.nodes[i].element.restore_position(v)
        for name in ck.get("unresumable_sources", ()):
            self.bus.post(Message(
                "pipeline", "resume-warning", 0,
                {"reason": f"{name} is a live source; its stream resumes "
                           "from the current producer position"}))

    def _drain_messages(self, batch: FrameBatch, messages) -> None:
        if not messages:
            return
        pts = np.asarray(batch.pts)
        for key, fields in messages.items():
            el_name, struct = key.split(":", 1)
            np_fields = {k: np.asarray(v) for k, v in fields.items()}
            emit = np_fields.pop("_emit", None)
            msg_pts = np_fields.pop("_pts", None)
            n = next(iter(np_fields.values())).shape[0] if np_fields else 0
            for b in range(n):
                if emit is not None and not emit[b]:
                    continue
                p = int(msg_pts[b]) if msg_pts is not None else (
                    int(pts[b]) if b < pts.shape[0] else 0)
                self.bus.post(Message(el_name, struct, p,
                                      {k: v[b].item() if v[b].ndim == 0
                                       else v[b] for k, v in
                                       np_fields.items()}))

    def __repr__(self):
        return " ! ".join(e.NAME for e in self.elements)


def parse_launch(description: str) -> Pipeline:
    """Parse a gst-launch-1.0 style description into a Pipeline DAG.

    Grammar subset: `element prop=value ... ! next ...`; whitespace between
    chains starts a new chain; `element name=foo` names a node; `foo.` at a
    chain start continues from node foo (tee-style fan-out), and `! foo.`
    links the current chain INTO node foo as an additional input (aggregator
    fan-in).  `video/x-raw,...` caps segments constrain the upstream element.
    """
    tokens = shlex.split(description)

    # tokenize into (segment_tokens, linked_from_prev)
    segments: List[Tuple[List[str], bool]] = []
    cur: List[str] = []
    pending_linked = False
    for tok in tokens:
        if tok == "!":
            if cur:
                segments.append((cur, pending_linked))
                cur = []
            pending_linked = True
            continue
        if cur:
            if "=" in tok and not tok.startswith(("video/", "audio/")):
                cur.append(tok)  # a property of the current element
                continue
            segments.append((cur, pending_linked))  # new chain starts
            cur = []
            pending_linked = False
        cur.append(tok)
    if cur:
        segments.append((cur, pending_linked))

    nodes: List[Node] = []
    named: Dict[str, Node] = {}
    pending_links: List[Tuple[Node, str]] = []  # forward fan-in refs
    prev: Optional[Node] = None

    for seg_tokens, linked in segments:
        head = seg_tokens[0]
        if head.endswith(".") and len(head) > 1:
            name = head[:-1]
            if linked:
                # `! foo.` — fan the current chain INTO node foo
                if prev is None:
                    raise ValueError(f"dangling link into {head!r}")
                if name in named:
                    named[name].inputs.append(prev)
                else:
                    pending_links.append((prev, name))
                prev = None
            else:
                # `foo. ! ...` — continue a new chain from node foo
                if name not in named:
                    raise ValueError(f"unknown element ref {head!r}")
                prev = named[name]
            continue
        if head.startswith(("video/", "audio/")):
            if prev is None:
                raise ValueError("capsfilter with no upstream element")
            _apply_capsfilter(prev.element, head)
            continue
        props = {}
        name = None
        for t in seg_tokens[1:]:
            k, v = t.split("=", 1)
            if k == "name":
                name = v
            else:
                props[k] = v
        node = Node(make(head, **props), name)
        if linked:
            if prev is None:
                raise ValueError(f"dangling link into {head!r}")
            node.inputs.append(prev)
        nodes.append(node)
        if name:
            named[name] = node
        prev = node

    pend: Dict[str, List[Node]] = {}
    for src, name in pending_links:
        if name not in named:
            raise ValueError(f"unresolved element ref {name!r}.")
        pend.setdefault(name, []).append(src)
    for name, srcs in pend.items():
        # links made before the element's declaration keep their order and
        # precede later ones (first link = first sink pad)
        named[name].inputs = srcs + named[name].inputs
    return Pipeline(nodes=nodes)


def _apply_capsfilter(el: Element, seg: str) -> None:
    """Apply `video/x-raw,key=value,...` constraints to an element."""
    media, _, rest = seg.partition(",")
    for part in rest.split(",") if rest else []:
        k, _, v = part.partition("=")
        k, v = k.strip(), v.strip()
        if k in ("format",) and "format" in el.props:
            el.set_property("format", v)
        if k in ("width", "height", "rate", "channels") and k in el.props:
            el.set_property(k, int(v))
        if k == "framerate" and "framerate" in el.props:
            el.set_property("framerate", v)
