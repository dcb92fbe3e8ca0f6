"""k-ary fat-tree (Al-Fares et al., SIGCOMM 2008; the paper's Fig. 4a) as
plain arrays: k pods of k/2 edge and k/2 aggregation switches, (k/2)^2
cores, (k/2)^2 servers a pod, one 10 Gbps grey wavelength a link, every
link both ways.  Powers from the paper's Table II: SG500XG-8F8T switches
94.33 W, an SFP+ transceiver 1 W a server.  Each switch's ingress rate
is k links' worth."""
import numpy as np

LINK_GBPS = 10.0
O_SG500 = 94.33
P_SFP = 1.0


def build(k: int, slot_duration: float = 1.0) -> dict:
    half = k // 2
    names, kinds, p_max = [], [], []
    edges = []

    def add(name, kind, p):
        names.append(name)
        kinds.append(kind)
        p_max.append(p)
        return len(names) - 1

    def link(u, v):
        edges.append((u, v))
        edges.append((v, u))

    core = [add(f"core{i}", "switch", O_SG500) for i in range(half * half)]
    switches = list(core)
    n_srv = 0
    for p in range(k):
        aggs = [add(f"agg{p}.{i}", "switch", O_SG500) for i in range(half)]
        edge_sw = [add(f"edge{p}.{i}", "switch", O_SG500)
                   for i in range(half)]
        switches += aggs + edge_sw
        for e in edge_sw:
            for a in aggs:
                link(e, a)
            for _ in range(half):
                link(add(f"srv{p}.{n_srv % (half * half)}", "server",
                         P_SFP), e)
                n_srv += 1
        for i, a in enumerate(aggs):
            for j in range(half):
                link(a, core[i * half + j])
    V = len(names)
    sigma = np.full(V, np.inf)
    sigma[switches] = k * LINK_GBPS
    return dict(
        name=f"fat-tree-k{k}", names=names, kinds=kinds,
        p_max=np.asarray(p_max, dtype=np.float64), eps=np.zeros(V),
        edges=np.asarray(edges, dtype=np.int64),
        cap=np.full((len(edges), 1), LINK_GBPS),
        slot_duration=float(slot_duration), sigma=sigma,
        server_relay=True, one_wavelength_tx=False, awgr_in=[])
