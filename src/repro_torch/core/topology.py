"""Data-centre topology graphs (paper §IV-A, Figs. 4-5, Table II).

A numpy copy of the reference `repro.core.topology`, kept array-for-array
equal to it (tests/test_torch_problem.py holds the two bitwise equal).

Each topology is a directed multigraph over *devices* (servers, switches,
OLT ports, polymer backplanes, AWGR ports) with per-wavelength link
capacities.  The schema is deliberately uniform so the time-slotted
scheduler (core.timeslot) and both solver backends operate on any of the
six paper DCNs or the TPU fabric (core.fabric) unchanged.

Paper parameters (Tables II & III):
  * link capacity: 10 Gbps per wavelength, all topologies
  * switch power:  SG500XG-8F8T 94.33 W, Nexus 3524X 193 W, OLT card 217 W,
                   4x4 polymer backplane 12 W, AWGR 0 W (passive)
  * server-side:   SFP+ transceiver 1 W (switch-centric),
                   PE10G2T-SR NIC 14 W + 14.29 W/Gbps offload (server-centric),
                   tunable DWDM transceiver 2 W (PON3)
  * slot duration: 1 s electronic & PON5, 0.25 s PON3 (paper §VI-B)
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np

LINK_GBPS = 10.0

# Power constants (Watts) — Table II / §IV-A.
P_SFP_TRANSCEIVER = 1.0     # grey SFP+ in a server (switch-centric DCNs)
P_TUNABLE = 2.0             # SFP-10GDWZR-TC tunable DWDM (PON3 servers)
P_NIC = 14.0                # PE10G2T-SR two-port NIC (server-centric DCNs)
EPS_NIC = 14.29             # W per Gbps of NIC-offloaded traffic (server CPU)
O_SG500 = 94.33             # SG500XG-8F8T ToR switch
O_NEXUS = 193.0             # Cisco Nexus 3524X (spine-leaf)
O_OLT = 217.0               # ZXA10 C300 OLT, one Ethernet card
O_BACKPLANE = 12.0          # 4x4 polymer optical backplane (per rack)
O_AWGR = 0.0                # passive

KIND_SERVER = "server"
KIND_SWITCH = "switch"      # anything billed via eq. (21): switch/OLT/backplane
KIND_PASSIVE = "passive"    # AWGR ports: zero power, never billed


@dataclasses.dataclass(frozen=True)
class Device:
    name: str
    kind: str                    # server | switch | passive
    p_max: float = 0.0           # W when active in a slot (eqs. 19-21)
    eps: float = 0.0             # W/Gbps NIC offload term (eq. 20)


@dataclasses.dataclass
class Topology:
    """A DCN instance in the uniform schema used by the scheduler."""

    name: str
    devices: list[Device]
    edges: np.ndarray            # (E, 2) int32, directed (u, v)
    cap: np.ndarray              # (E, W) float, Gbps per wavelength
    n_wavelengths: int
    slot_duration: float         # D, seconds
    task_servers: list[int]      # servers eligible for map/reduce tasks
    server_relay: bool = True    # False => paper eq. (46) (PON3)
    one_wavelength_tx: bool = False  # paper eq. (47) (PON3 tunable lasers)
    awgr_in_ports: list[int] = dataclasses.field(default_factory=list)
    switch_sigma: dict[int, float] = dataclasses.field(default_factory=dict)

    # ---- derived --------------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return len(self.devices)

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def servers(self) -> list[int]:
        return [i for i, d in enumerate(self.devices) if d.kind == KIND_SERVER]

    @property
    def switches(self) -> list[int]:
        return [i for i, d in enumerate(self.devices) if d.kind == KIND_SWITCH]

    def static_power(self) -> float:
        """Sum of p_max over all billable devices (everything ON)."""
        return float(sum(d.p_max for d in self.devices))

    def validate(self) -> None:
        assert self.edges.ndim == 2 and self.edges.shape[1] == 2
        assert self.cap.shape == (self.n_edges, self.n_wavelengths)
        assert int(self.edges.max(initial=-1)) < self.n_vertices
        # every directed edge has a reverse (all paper links bidirectional)
        fwd = {(int(u), int(v)) for u, v in self.edges}
        assert all((v, u) in fwd for (u, v) in fwd), "missing reverse edges"


class _Builder:
    def __init__(self, name: str):
        self.name = name
        self.devices: list[Device] = []
        self.edges: list[tuple[int, int]] = []
        self.caps: list[np.ndarray] = []

    def add(self, name: str, kind: str, p_max: float = 0.0, eps: float = 0.0) -> int:
        self.devices.append(Device(name, kind, p_max, eps))
        return len(self.devices) - 1

    def link(self, u: int, v: int, cap_w: np.ndarray) -> None:
        """Add a bidirectional link with per-wavelength capacity row cap_w."""
        self.edges.append((u, v))
        self.caps.append(cap_w)
        self.edges.append((v, u))
        self.caps.append(cap_w)

    def build(self, *, n_wavelengths: int, slot_duration: float,
              task_servers: Sequence[int] | None = None, **kw) -> Topology:
        edges = np.asarray(self.edges, dtype=np.int32)
        cap = np.stack(self.caps).astype(np.float64)
        servers = [i for i, d in enumerate(self.devices) if d.kind == KIND_SERVER]
        topo = Topology(
            name=self.name, devices=self.devices, edges=edges, cap=cap,
            n_wavelengths=n_wavelengths, slot_duration=slot_duration,
            task_servers=list(task_servers) if task_servers is not None else servers,
            **kw)
        topo.validate()
        return topo


def _grey(w: int = 1) -> np.ndarray:
    """Single-channel 10G link (wavelength 0 carries, the rest are dark)."""
    row = np.zeros(w)
    row[0] = LINK_GBPS
    return row


# ---------------------------------------------------------------------------
# Electronic DCNs (Fig. 4)
# ---------------------------------------------------------------------------

def fat_tree(k: int = 4, slot_duration: float = 1.0) -> Topology:
    """k-ary fat-tree (Fig. 4a): k pods, (k/2)^2 servers/pod; k=4 => 16 servers,
    20 switches, 48 bidirectional links."""
    b = _Builder(f"fat-tree-k{k}")
    half = k // 2
    core = [b.add(f"core{i}", KIND_SWITCH, O_SG500) for i in range(half * half)]
    servers, edge_sw, agg_sw = [], [], []
    for p in range(k):
        aggs = [b.add(f"agg{p}.{i}", KIND_SWITCH, O_SG500) for i in range(half)]
        edges_ = [b.add(f"edge{p}.{i}", KIND_SWITCH, O_SG500) for i in range(half)]
        agg_sw += aggs
        edge_sw += edges_
        for e in edges_:
            for a in aggs:
                b.link(e, a, _grey())
            for s in range(half):
                sv = b.add(f"srv{p}.{len(servers) % (half * half)}",
                           KIND_SERVER, P_SFP_TRANSCEIVER)
                servers.append(sv)
                b.link(sv, e, _grey())
        for i, a in enumerate(aggs):
            for j in range(half):
                b.link(a, core[i * half + j], _grey())
    sigma = {s: k * LINK_GBPS for s in core + agg_sw + edge_sw}
    return b.build(n_wavelengths=1, slot_duration=slot_duration,
                   switch_sigma=sigma)


def spine_leaf(n_servers: int = 16, n_leaf: int = 4, n_spine: int = 2,
               slot_duration: float = 1.0) -> Topology:
    """Spine-leaf (Fig. 4b): 16 servers, 4 leaf + 2 spine Nexus 3524X,
    24 bidirectional links."""
    b = _Builder("spine-leaf")
    spines = [b.add(f"spine{i}", KIND_SWITCH, O_NEXUS) for i in range(n_spine)]
    leaves = [b.add(f"leaf{i}", KIND_SWITCH, O_NEXUS) for i in range(n_leaf)]
    per_leaf = n_servers // n_leaf
    for li, l in enumerate(leaves):
        for s in spines:
            b.link(l, s, _grey())
        for j in range(per_leaf):
            sv = b.add(f"srv{li}.{j}", KIND_SERVER, P_SFP_TRANSCEIVER)
            b.link(sv, l, _grey())
    sigma = {s: 48 * LINK_GBPS for s in spines + leaves}  # Nexus 3524X: 480 Gbps
    return b.build(n_wavelengths=1, slot_duration=slot_duration,
                   switch_sigma=sigma)


def bcube(n: int = 4, slot_duration: float = 1.0) -> Topology:
    """BCube(k=1, n) (Fig. 4c): n^2 servers, 2n switches, 2n^2 links.
    Server-centric: servers relay; NIC power model applies."""
    b = _Builder(f"bcube-n{n}")
    servers = [[b.add(f"srv{g}.{i}", KIND_SERVER, P_NIC, EPS_NIC)
                for i in range(n)] for g in range(n)]
    lvl0 = [b.add(f"sw0.{g}", KIND_SWITCH, O_SG500) for g in range(n)]
    lvl1 = [b.add(f"sw1.{i}", KIND_SWITCH, O_SG500) for i in range(n)]
    for g in range(n):
        for i in range(n):
            b.link(servers[g][i], lvl0[g], _grey())
            b.link(servers[g][i], lvl1[i], _grey())
    sigma = {s: n * LINK_GBPS for s in lvl0 + lvl1}
    return b.build(n_wavelengths=1, slot_duration=slot_duration,
                   switch_sigma=sigma)


def dcell(n: int = 4, slot_duration: float = 1.0,
          n_task_servers: int = 16) -> Topology:
    """DCell_1(n=4) (Fig. 4d): 5 DCell_0 x 4 servers = 20 servers, 5 switches,
    30 links.  Only 16 servers take tasks (paper: remaining 4 route only)."""
    b = _Builder(f"dcell-n{n}")
    n_cells = n + 1
    servers = [[b.add(f"srv{c}.{i}", KIND_SERVER, P_NIC, EPS_NIC)
                for i in range(n)] for c in range(n_cells)]
    switches = [b.add(f"sw{c}", KIND_SWITCH, O_SG500) for c in range(n_cells)]
    for c in range(n_cells):
        for i in range(n):
            b.link(servers[c][i], switches[c], _grey())
    # DCell_1 interconnect: cell c server (c2-1) <-> cell c2 server (c)  [DCell paper]
    for c, c2 in itertools.combinations(range(n_cells), 2):
        b.link(servers[c][c2 - 1], servers[c2][c], _grey())
    # spread tasks round-robin across cells so the 4 idle servers are spread out
    flat = [servers[c][i] for i in range(n) for c in range(n_cells)]
    sigma = {s: n * LINK_GBPS for s in switches}
    return b.build(n_wavelengths=1, slot_duration=slot_duration,
                   task_servers=flat[:n_task_servers], switch_sigma=sigma)


def _dcell_cell(b: _Builder, n: int, level: int, prefix: str) -> list[int]:
    """Recursively build one DCell_level into `b`; returns its servers in
    flat order (the order the DCell construction indexes them by)."""
    if level == 0:
        sw = b.add(f"{prefix}sw", KIND_SWITCH, O_SG500)
        servers = [b.add(f"{prefix}srv{i}", KIND_SERVER, P_NIC, EPS_NIC)
                   for i in range(n)]
        for s in servers:
            b.link(s, sw, _grey())
        return servers
    first = _dcell_cell(b, n, level - 1, f"{prefix}c0.")
    g = len(first) + 1                 # g_l = t_{l-1} + 1 sub-cells
    subs = [first] + [_dcell_cell(b, n, level - 1, f"{prefix}c{a}.")
                      for a in range(1, g)]
    # level-l interconnect: sub-cell a server (a2-1) <-> sub-cell a2
    # server (a) — each server gains exactly one link per level, so a
    # DCell_l contributes t_l/2 new bidirectional links
    for a, a2 in itertools.combinations(range(g), 2):
        b.link(subs[a][a2 - 1], subs[a2][a], _grey())
    return [s for sub in subs for s in sub]


def dcell_multi(n: int = 2, levels: int = 2,
                slot_duration: float = 1.0) -> Topology:
    """Multi-level DCell_levels(n) (DCell paper §2; generalizes `dcell`).

    Server counts grow doubly-exponentially: t_0 = n, t_l = (t_{l-1}+1)
    * t_{l-1}.  Every server has degree levels+1 (one switch port plus
    one port per level); there are t_levels/n level-0 switches and
    t_levels * (2 + levels) directed edges.  All servers take tasks
    (unlike the 20-server paper instance, which idles 4)."""
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    b = _Builder(f"dcell-l{levels}-n{n}")
    _dcell_cell(b, n, levels, "")
    sigma = {i: n * LINK_GBPS for i, d in enumerate(b.devices)
             if d.kind == KIND_SWITCH}
    return b.build(n_wavelengths=1, slot_duration=slot_duration,
                   switch_sigma=sigma)


# ---------------------------------------------------------------------------
# PON-based DCNs (Fig. 5)
# ---------------------------------------------------------------------------

# Wavelength routing table for the 4-rack + OLT AWGR cell, from the §III MILP
# (Table I): LAMBDA[src][dst] = wavelength index used from vertex src to dst,
# where index 0..3 = rack 1..4 and 4 = OLT port.
TABLE_I_LAMBDA = np.array([
    #  r1  r2  r3  r4  olt
    [-1,  2,  3,  0,  1],   # from rack 1
    [ 3, -1,  1,  2,  0],   # from rack 2
    [ 0,  3, -1,  1,  2],   # from rack 3
    [ 1,  0,  2, -1,  3],   # from rack 4
    [ 2,  1,  0,  3, -1],   # from OLT
])


def pon3(n_racks: int = 4, servers_per_rack: int = 4,
         slot_duration: float = 0.25,
         lam: np.ndarray | None = None) -> Topology:
    """AWGR-centric PON cell (PON3, Fig. 5a).

    §III's MILP output (Table I) fixes which wavelength connects each ordered
    (rack, rack/OLT) pair; we expose that as per-wavelength capacity on
    aggregated rack-ingress -> rack-egress edges.  Servers reach their rack's
    AWGR ingress with a tunable laser (one wavelength per slot, eq. 47) and
    receive on any wavelength (wideband receiver).  Intra-rack traffic uses
    the polymer backplane.  Servers never relay (eq. 46).
    """
    if lam is None:
        lam = TABLE_I_LAMBDA
    n_w = n_racks  # G-1 wavelengths for G = racks + OLT communicating vertices
    b = _Builder("pon3")
    olt = b.add("olt", KIND_SWITCH, O_OLT)
    racks: list[list[int]] = []
    bps, ins, outs = [], [], []
    for r in range(n_racks):
        bp = b.add(f"backplane{r}", KIND_SWITCH, O_BACKPLANE)
        ain = b.add(f"awgr_in{r}", KIND_PASSIVE)
        aout = b.add(f"awgr_out{r}", KIND_PASSIVE)
        bps.append(bp); ins.append(ain); outs.append(aout)
        row = []
        for i in range(servers_per_rack):
            sv = b.add(f"srv{r}.{i}", KIND_SERVER, P_TUNABLE)
            row.append(sv)
            b.link(sv, bp, _grey(n_w))                      # backplane, grey
            # tunable TX to rack ingress: any wavelength (eq. 47 limits to 1/slot)
            b.edges.append((sv, ain)); b.caps.append(np.full(n_w, LINK_GBPS))
            # wideband RX from rack egress: all wavelengths simultaneously
            b.edges.append((aout, sv)); b.caps.append(np.full(n_w, LINK_GBPS))
        racks.append(row)
    # OLT ingress/egress ports on the AWGRs
    olt_in = b.add("awgr_in_olt", KIND_PASSIVE)
    olt_out = b.add("awgr_out_olt", KIND_PASSIVE)
    b.edges.append((olt, olt_in)); b.caps.append(np.full(n_w, LINK_GBPS))
    b.edges.append((olt_out, olt)); b.caps.append(np.full(n_w, LINK_GBPS))
    ins_all = ins + [olt_in]
    outs_all = outs + [olt_out]
    # AWGR wavelength-routed paths: ingress of src -> egress of dst on lam[src,dst]
    for s in range(n_racks + 1):
        for d in range(n_racks + 1):
            if s == d:
                continue
            row = np.zeros(n_w)
            row[int(lam[s, d])] = LINK_GBPS
            b.edges.append((ins_all[s], outs_all[d])); b.caps.append(row)

    edges = np.asarray(b.edges, dtype=np.int32)
    cap = np.stack(b.caps)
    topo = Topology(
        name="pon3", devices=b.devices, edges=edges, cap=cap,
        n_wavelengths=n_w, slot_duration=slot_duration,
        task_servers=[i for i, d in enumerate(b.devices) if d.kind == KIND_SERVER],
        server_relay=False, one_wavelength_tx=True,
        awgr_in_ports=ins_all,
        switch_sigma={olt: 4 * LINK_GBPS,
                      **{bp: servers_per_rack * LINK_GBPS for bp in bps}})
    # NOTE: PON3 edges are intentionally directional (AWGR paths are one-way),
    # so Topology.validate()'s bidirectional check is skipped.
    assert cap.shape == (edges.shape[0], n_w)
    return topo


def pon5(n_racks: int = 4, servers_per_rack: int = 4,
         slot_duration: float = 1.0) -> Topology:
    """Server-centric PON cell (PON5, Fig. 5b).

    Each rack: polymer backplane for intra-rack traffic; one gateway server
    uplinks to the OLT through the AWG (10 G per gateway, WDM); inter-rack
    traffic is relayed server-to-server through paired NIC ports (one
    bidirectional NIC link per rack pair).  NIC power model (eq. 20).
    """
    b = _Builder("pon5")
    olt = b.add("olt", KIND_SWITCH, O_OLT)
    racks: list[list[int]] = []
    for r in range(n_racks):
        bp = b.add(f"backplane{r}", KIND_SWITCH, O_BACKPLANE)
        row = []
        for i in range(servers_per_rack):
            sv = b.add(f"srv{r}.{i}", KIND_SERVER, P_NIC, EPS_NIC)
            row.append(sv)
            b.link(sv, bp, _grey())
        racks.append(row)
        b.link(row[0], olt, _grey())  # gateway server <-> OLT (via AWG, 10G)
    # inter-rack NIC links: rack r server idx(r') <-> rack r' server idx(r)
    for r, r2 in itertools.combinations(range(n_racks), 2):
        u = racks[r][r2 % servers_per_rack]
        v = racks[r2][r % servers_per_rack]
        b.link(u, v, _grey())
    sigma = {olt: n_racks * LINK_GBPS}
    for r in range(n_racks):
        sigma[racks[r][0] - 1] = servers_per_rack * LINK_GBPS  # backplane idx
    return b.build(n_wavelengths=1, slot_duration=slot_duration,
                   switch_sigma=sigma)


def awgr_lambda(G: int) -> np.ndarray:
    """Cyclic AWGR wavelength-routing table for G communicating vertices.

    lam[s][d] = (d - s - 1) mod G for s != d (-1 on the diagonal): a
    latin square over wavelengths 0..G-2 — every row and every column
    uses each wavelength at most once, which is exactly the AWGR's
    physical constraint (one wavelength per ingress and per egress
    port).  awgr_lambda(5) is wavelength-equivalent to the §III MILP
    output TABLE_I_LAMBDA up to relabeling; this closed form scales the
    cell to any G."""
    d = np.arange(G)
    lam = (d[None, :] - d[:, None] - 1) % G
    np.fill_diagonal(lam, -1)
    return lam


def pon_multicell(n_cells: int = 2, n_racks: int = 4,
                  servers_per_rack: int = 4,
                  slot_duration: float = 0.25) -> Topology:
    """Multi-cell AWGR-centric PON DCN (PON3 cells behind a WDM hub).

    Each cell is a pon3 instance — racks with polymer backplanes,
    tunable-TX servers, a cyclic-AWGR wavelength fabric (awgr_lambda)
    and an OLT card — and the cells' OLT cards interconnect through a
    central OLT hub chassis over full-WDM trunks (all n_racks
    wavelengths both ways), the paper's scale-out story for PON cells.
    Same uniform schema: directional AWGR edges, servers never relay
    (eq. 46), one wavelength per server TX per slot (eq. 47)."""
    if n_cells < 1:
        raise ValueError(f"n_cells must be >= 1, got {n_cells}")
    G = n_racks + 1
    lam = awgr_lambda(G)
    n_w = n_racks                      # G-1 wavelengths per cell
    b = _Builder(f"pon-multicell-{n_cells}x{n_racks}")
    hub = b.add("olt-hub", KIND_SWITCH, O_OLT)
    awgr_ins: list[int] = []
    bps_all: list[int] = []
    cards: list[int] = []
    for cell in range(n_cells):
        olt = b.add(f"olt{cell}", KIND_SWITCH, O_OLT)
        cards.append(olt)
        # WDM trunk to the hub: every wavelength, both directions
        b.edges.append((olt, hub)); b.caps.append(np.full(n_w, LINK_GBPS))
        b.edges.append((hub, olt)); b.caps.append(np.full(n_w, LINK_GBPS))
        ins, outs = [], []
        for r in range(n_racks):
            bp = b.add(f"backplane{cell}.{r}", KIND_SWITCH, O_BACKPLANE)
            ain = b.add(f"awgr_in{cell}.{r}", KIND_PASSIVE)
            aout = b.add(f"awgr_out{cell}.{r}", KIND_PASSIVE)
            bps_all.append(bp); ins.append(ain); outs.append(aout)
            for i in range(servers_per_rack):
                sv = b.add(f"srv{cell}.{r}.{i}", KIND_SERVER, P_TUNABLE)
                b.link(sv, bp, _grey(n_w))
                b.edges.append((sv, ain))
                b.caps.append(np.full(n_w, LINK_GBPS))
                b.edges.append((aout, sv))
                b.caps.append(np.full(n_w, LINK_GBPS))
        olt_in = b.add(f"awgr_in_olt{cell}", KIND_PASSIVE)
        olt_out = b.add(f"awgr_out_olt{cell}", KIND_PASSIVE)
        b.edges.append((olt, olt_in)); b.caps.append(np.full(n_w, LINK_GBPS))
        b.edges.append((olt_out, olt)); b.caps.append(np.full(n_w, LINK_GBPS))
        ins_all = ins + [olt_in]
        outs_all = outs + [olt_out]
        for s in range(G):
            for d_ in range(G):
                if s == d_:
                    continue
                row = np.zeros(n_w)
                row[int(lam[s, d_])] = LINK_GBPS
                b.edges.append((ins_all[s], outs_all[d_]))
                b.caps.append(row)
        awgr_ins += ins_all

    edges = np.asarray(b.edges, dtype=np.int32)
    cap = np.stack(b.caps)
    topo = Topology(
        name=b.name, devices=b.devices, edges=edges, cap=cap,
        n_wavelengths=n_w, slot_duration=slot_duration,
        task_servers=[i for i, d in enumerate(b.devices)
                      if d.kind == KIND_SERVER],
        server_relay=False, one_wavelength_tx=True,
        awgr_in_ports=awgr_ins,
        switch_sigma={hub: n_cells * n_racks * LINK_GBPS,
                      **{c: n_racks * LINK_GBPS for c in cards},
                      **{bp: servers_per_rack * LINK_GBPS
                         for bp in bps_all}})
    # NOTE: like pon3, AWGR paths are one-way, so Topology.validate()'s
    # bidirectional check is skipped.
    assert cap.shape == (edges.shape[0], n_w)
    return topo


def pon_cascaded(n_cells: int = 2, n_racks: int = 4,
                 servers_per_rack: int = 2,
                 slot_duration: float = 0.25) -> Topology:
    """Cascaded-AWGR PON DCN (arXiv:2111.01263 style, two passive stages).

    Each cell is an AWGR-centric PON3 instance (polymer backplanes,
    tunable-TX servers, cyclic-AWGR wavelength fabric, one OLT card).
    Unlike `pon_multicell` — whose cells meet at an *electronic* hub
    chassis — the cells here interconnect through a second, entirely
    passive AWGR stage: each cell's OLT card feeds a cascade ingress
    port, and the stage-2 AWGR wavelength-routes cell c -> cell c' on
    the cyclic table `awgr_lambda(n_cells)`.  The only electronic
    devices in the inter-cell path are the two OLT cards themselves,
    which perform wavelength conversion between the stage-1 and stage-2
    λ-plans; the core is zero-power.

    Wavelength budget: stage 1 uses n_racks wavelengths per cell (G-1
    for G = racks + OLT), stage 2 uses n_cells - 1, and the fabric
    carries max of the two.  Same uniform schema as pon3: directional
    AWGR edges, servers never relay (eq. 46), one TX wavelength per
    server per slot (eq. 47)."""
    if n_cells < 2:
        raise ValueError(f"n_cells must be >= 2, got {n_cells}")
    G = n_racks + 1
    lam = awgr_lambda(G)
    lam2 = awgr_lambda(n_cells)
    n_w = max(n_racks, n_cells - 1)
    b = _Builder(f"pon-cascaded-{n_cells}x{n_racks}")
    awgr_ins: list[int] = []
    bps_all: list[int] = []
    cards: list[int] = []
    cas_in: list[int] = []
    cas_out: list[int] = []
    for cell in range(n_cells):
        olt = b.add(f"olt{cell}", KIND_SWITCH, O_OLT)
        cards.append(olt)
        ins, outs = [], []
        for r in range(n_racks):
            bp = b.add(f"backplane{cell}.{r}", KIND_SWITCH, O_BACKPLANE)
            ain = b.add(f"awgr_in{cell}.{r}", KIND_PASSIVE)
            aout = b.add(f"awgr_out{cell}.{r}", KIND_PASSIVE)
            bps_all.append(bp); ins.append(ain); outs.append(aout)
            for i in range(servers_per_rack):
                sv = b.add(f"srv{cell}.{r}.{i}", KIND_SERVER, P_TUNABLE)
                b.link(sv, bp, _grey(n_w))
                b.edges.append((sv, ain))
                b.caps.append(np.full(n_w, LINK_GBPS))
                b.edges.append((aout, sv))
                b.caps.append(np.full(n_w, LINK_GBPS))
        olt_in = b.add(f"awgr_in_olt{cell}", KIND_PASSIVE)
        olt_out = b.add(f"awgr_out_olt{cell}", KIND_PASSIVE)
        b.edges.append((olt, olt_in)); b.caps.append(np.full(n_w, LINK_GBPS))
        b.edges.append((olt_out, olt)); b.caps.append(np.full(n_w, LINK_GBPS))
        ins_all = ins + [olt_in]
        outs_all = outs + [olt_out]
        # stage-1 AWGR: wavelengths 0..n_racks-1 inside the cell
        for s in range(G):
            for d_ in range(G):
                if s == d_:
                    continue
                row = np.zeros(n_w)
                row[int(lam[s, d_])] = LINK_GBPS
                b.edges.append((ins_all[s], outs_all[d_]))
                b.caps.append(row)
        awgr_ins += ins_all
        # cascade ports: the OLT card converts any stage-1 wavelength
        # onto the stage-2 λ-plan (full-WDM feeder both ways)
        cin = b.add(f"cas_in{cell}", KIND_PASSIVE)
        cout = b.add(f"cas_out{cell}", KIND_PASSIVE)
        cas_in.append(cin); cas_out.append(cout)
        b.edges.append((olt, cin)); b.caps.append(np.full(n_w, LINK_GBPS))
        b.edges.append((cout, olt)); b.caps.append(np.full(n_w, LINK_GBPS))
    # stage-2 AWGR: cell c -> cell c' on wavelength lam2[c, c'] — a
    # latin square over 0..n_cells-2, the passive core of the cascade
    for c in range(n_cells):
        for c2 in range(n_cells):
            if c == c2:
                continue
            row = np.zeros(n_w)
            row[int(lam2[c, c2])] = LINK_GBPS
            b.edges.append((cas_in[c], cas_out[c2]))
            b.caps.append(row)

    edges = np.asarray(b.edges, dtype=np.int32)
    cap = np.stack(b.caps)
    topo = Topology(
        name=b.name, devices=b.devices, edges=edges, cap=cap,
        n_wavelengths=n_w, slot_duration=slot_duration,
        task_servers=[i for i, d in enumerate(b.devices)
                      if d.kind == KIND_SERVER],
        server_relay=False, one_wavelength_tx=True,
        awgr_in_ports=awgr_ins + cas_in,
        switch_sigma={**{c: 2 * n_w * LINK_GBPS for c in cards},
                      **{bp: servers_per_rack * LINK_GBPS
                         for bp in bps_all}})
    # NOTE: like pon3, AWGR paths are one-way, so Topology.validate()'s
    # bidirectional check is skipped.
    assert cap.shape == (edges.shape[0], n_w)
    return topo


BUILDERS = {
    "fat-tree": fat_tree,
    "spine-leaf": spine_leaf,
    "bcube": bcube,
    "dcell": dcell,
    "dcell-multi": dcell_multi,
    "pon3": pon3,
    "pon5": pon5,
    "pon-multicell": pon_multicell,
    "pon-cascaded": pon_cascaded,
}


def build(name: str, **kw) -> Topology:
    return BUILDERS[name](**kw)
