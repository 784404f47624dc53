"""How the port's tests carry inputs across the two packages.

Graphs and cost models cross as plain data (``graph_from_description``,
``cost_from_scalars``), so no object of one package reaches the other. The
reference's CSR oracle ``repro/kernels/partition_sweep/ref.py`` cannot be
imported the normal way (its package ``__init__`` pulls in the Pallas
wrapper), so :func:`load_ref_oracle` loads it by file path.
"""

import importlib.util
from pathlib import Path

import repro.core
from repro.core.cost import cost_scalars as ref_cost_scalars

from repro_torch.core.cost import cost_from_scalars
from repro_torch.core.graph import graph_from_description


def load_ref_oracle():
    path = Path(repro.core.__file__).parents[1] / "kernels" / "partition_sweep" / "ref.py"
    spec = importlib.util.spec_from_file_location(
        "repro.kernels.partition_sweep.ref", path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "repro.kernels.partition_sweep"
    spec.loader.exec_module(mod)
    return mod


def port_cost(cm):
    """The reference's cost model as the port's, name included."""
    return cost_from_scalars(ref_cost_scalars(cm), name=cm.name)


def port_of(g, cm):
    """(the port's copy of graph ``g``, of cost model ``cm``)."""
    packets = [dict(name=p.name, nbytes=p.nbytes, c0_weight=p.c0_weight,
                    keep=p.keep, external=p.external) for p in g.packets.values()]
    tasks = [dict(name=t.name, reads=t.reads, writes=t.writes, cost=t.cost)
             for t in g.tasks]
    return graph_from_description(packets, tasks), port_cost(cm)


def port_placement_spec(spec):
    """The reference's ``PlacementSpec`` as the port's: the same nodes (each
    node cost model carried by ``port_cost``, one port model per reference
    model), links, Q and memory scales."""
    from repro_torch.core import placement as P

    costs = {}

    def cost_of(cm):
        if cm is None:
            return None
        return costs.setdefault(id(cm), port_cost(cm))

    nodes = tuple(P.NodeSpec(q_max=nd.q_max, memory_bytes=nd.memory_bytes,
                             cost=cost_of(nd.cost), compute_scale=nd.compute_scale,
                             name=nd.name) for nd in spec.nodes)
    links = tuple(P.LinkModel(bandwidth_mbps=lk.bandwidth_mbps,
                              energy_per_byte=lk.energy_per_byte,
                              init_energy=lk.init_energy, rx_fraction=lk.rx_fraction,
                              init_s=lk.init_s, name=lk.name) for lk in spec.links)
    return P.PlacementSpec(nodes=nodes, links=links, q_scales=spec.q_scales,
                           memory_scales=spec.memory_scales)
