"""TU-Dortmund dataset loading.

The counterpart of ``grakel_tpu/datasets/base.py``, format and semantics
of the reference (grakel/datasets/base.py:142-297): global 1-based node
ids shared across the whole dataset, per-graph edge sets keyed by those
global ids, node/edge labels or attributes chosen by the
``prefer_attr_*`` flags, degree-labels fallback, and a
``Bunch(data, target)`` return (the port's own, without scikit-learn).
Any directory holding the ``<name>_*.txt`` files can be read directly
with ``read_data``; ``fetch_dataset`` downloads into ``data_home``
(default ``~/grakel_torch_data``) first.
"""

from __future__ import annotations

import collections
import os
import zipfile

import numpy as np

from ..graph import Graph

__all__ = ["read_data", "fetch_dataset", "get_dataset_info",
           "dataset_metadata", "Bunch"]


class Bunch(dict):
    """A dict whose keys are also attributes (``sklearn.utils.Bunch``)."""

    def __init__(self, **kwargs):
        super().__init__(kwargs)

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key, value):
        self[key] = value

    def __dir__(self):
        return list(self.keys())


_BASE_URL = "https://www.chrsmrrs.com/graphkerneldatasets/"

# Registry of TU datasets: node labels (nl), edge labels (el), node
# attributes (na), edge attributes (ea).  Mirrors the reference's table
# (grakel/datasets/base.py:30-137).
dataset_metadata = {
    "AIDS": {"nl": True, "el": True, "na": True, "ea": False},
    "BZR": {"nl": True, "el": False, "na": True, "ea": False},
    "BZR_MD": {"nl": True, "el": True, "na": False, "ea": True},
    "COIL-DEL": {"nl": False, "el": True, "na": True, "ea": False},
    "COIL-RAG": {"nl": False, "el": False, "na": True, "ea": True},
    "COLLAB": {"nl": False, "el": False, "na": False, "ea": False},
    "COX2": {"nl": True, "el": False, "na": True, "ea": False},
    "COX2_MD": {"nl": True, "el": True, "na": False, "ea": True},
    "CUNEIFORM": {"nl": True, "el": True, "na": True, "ea": True},
    "Cuneiform": {"nl": True, "el": True, "na": True, "ea": True},
    "DD": {"nl": True, "el": False, "na": False, "ea": False},
    "DHFR": {"nl": True, "el": False, "na": True, "ea": False},
    "DHFR_MD": {"nl": True, "el": True, "na": False, "ea": True},
    "ENZYMES": {"nl": True, "el": False, "na": True, "ea": False},
    "ER_MD": {"nl": True, "el": True, "na": False, "ea": True},
    "FIRSTMM_DB": {"nl": True, "el": False, "na": True, "ea": True},
    "FRANKENSTEIN": {"nl": False, "el": False, "na": True, "ea": False},
    "IMDB-BINARY": {"nl": False, "el": False, "na": False, "ea": False},
    "IMDB-MULTI": {"nl": False, "el": False, "na": False, "ea": False},
    "KKI": {"nl": True, "el": False, "na": False, "ea": False},
    "Letter-high": {"nl": False, "el": False, "na": True, "ea": False},
    "Letter-low": {"nl": False, "el": False, "na": True, "ea": False},
    "Letter-med": {"nl": False, "el": False, "na": True, "ea": False},
    "Mutagenicity": {"nl": True, "el": True, "na": False, "ea": False},
    "MSRC_9": {"nl": True, "el": False, "na": False, "ea": False},
    "MSRC_21": {"nl": True, "el": False, "na": False, "ea": False},
    "MSRC_21C": {"nl": True, "el": False, "na": False, "ea": False},
    "MUTAG": {"nl": True, "el": True, "na": False, "ea": False},
    "NCI1": {"nl": True, "el": False, "na": False, "ea": False},
    "NCI109": {"nl": True, "el": False, "na": False, "ea": False},
    "OHSU": {"nl": True, "el": False, "na": False, "ea": False},
    "PETER": {"nl": True, "el": False, "na": False, "ea": False},
    "PROTEINS": {"nl": True, "el": False, "na": True, "ea": False},
    "PROTEINS_full": {"nl": True, "el": False, "na": True, "ea": False},
    "PTC_FM": {"nl": True, "el": True, "na": False, "ea": False},
    "PTC_FR": {"nl": True, "el": True, "na": False, "ea": False},
    "PTC_MM": {"nl": True, "el": True, "na": False, "ea": False},
    "PTC_MR": {"nl": True, "el": True, "na": False, "ea": False},
    "REDDIT-BINARY": {"nl": False, "el": False, "na": False, "ea": False},
    "REDDIT-MULTI-5K": {"nl": False, "el": False, "na": False, "ea": False},
    "REDDIT-MULTI-12K": {"nl": False, "el": False, "na": False, "ea": False},
    "FINGERPRINT": {"nl": False, "el": False, "na": True, "ea": True},
    "SYNTHETIC": {"nl": False, "el": False, "na": True, "ea": False},
    "SYNTHETICnew": {"nl": False, "el": False, "na": True, "ea": False},
    "Synthie": {"nl": False, "el": False, "na": True, "ea": False},
    "Tox21_AHR": {"nl": True, "el": True, "na": False, "ea": False},
    "Tox21_AR": {"nl": True, "el": True, "na": False, "ea": False},
    "Tox21_AR-LBD": {"nl": True, "el": True, "na": False, "ea": False},
    "Tox21_ARE": {"nl": True, "el": True, "na": False, "ea": False},
    "Tox21_aromatase": {"nl": True, "el": True, "na": False, "ea": False},
    "Tox21_ATAD5": {"nl": True, "el": True, "na": False, "ea": False},
    "Tox21_ER": {"nl": True, "el": True, "na": False, "ea": False},
    "Tox21_ER_LBD": {"nl": True, "el": True, "na": False, "ea": False},
    "Tox21_HSE": {"nl": True, "el": True, "na": False, "ea": False},
    "Tox21_MMP": {"nl": True, "el": True, "na": False, "ea": False},
    "Tox21_p53": {"nl": True, "el": True, "na": False, "ea": False},
    "Tox21_PPAR-gamma": {"nl": True, "el": True, "na": False, "ea": False},
    "ZINC_full": {"nl": True, "el": True, "na": False, "ea": False},
}


def get_dataset_info(name, default=None):
    """Metadata flags for a registered dataset name."""
    return dataset_metadata.get(name, default)


def read_data(name, path=".", with_classes=True, prefer_attr_nodes=False,
              prefer_attr_edges=False, produce_labels_nodes=False,
              as_graphs=False, is_symmetric=False):
    """Parse a TU-format dataset directory.

    ``path`` is the directory containing the ``<name>/`` folder with the
    ``<name>_graph_indicator.txt`` etc. files.  Reference:
    grakel/datasets/base.py:142-297 (including global 1-based node ids,
    optional symmetrization, degree-labels fallback).
    """
    d = os.path.join(path, str(name))
    p = lambda suffix: os.path.join(d, "%s_%s.txt" % (name, suffix))

    node_graph = {}           # global node id -> graph id
    graphs = collections.OrderedDict()     # graph id -> set of edges
    node_labels = collections.defaultdict(dict)
    edge_labels = collections.defaultdict(dict)

    with open(p("graph_indicator")) as f:
        for i, line in enumerate(f, 1):
            gid = int(line.strip())
            node_graph[i] = gid
            if gid not in graphs:
                graphs[gid] = set()
                node_labels[gid] = {}
                edge_labels[gid] = {}

    edge_line = {}            # edge file line -> (u, v)
    with open(p("A")) as f:
        for i, line in enumerate(f, 1):
            u, v = (int(x) for x in line.replace(" ", "").strip().split(","))
            edge_line[i] = (u, v)
            graphs[node_graph[u]].add((u, v))
            if is_symmetric:
                graphs[node_graph[v]].add((v, u))

    meta = dataset_metadata.get(name, {})
    if prefer_attr_nodes and meta.get("na", os.path.exists(p("node_attributes"))):
        with open(p("node_attributes")) as f:
            for i, line in enumerate(f, 1):
                node_labels[node_graph[i]][i] = [
                    float(x) for x in
                    line.replace(" ", "").strip().split(",")]
    elif meta.get("nl", os.path.exists(p("node_labels"))):
        with open(p("node_labels")) as f:
            for i, line in enumerate(f, 1):
                node_labels[node_graph[i]][i] = int(line.strip())
    elif produce_labels_nodes:
        for gid in graphs:
            node_labels[gid] = dict(collections.Counter(
                s for s, t in graphs[gid] if s != t))

    if prefer_attr_edges and meta.get("ea", os.path.exists(p("edge_attributes"))):
        with open(p("edge_attributes")) as f:
            for i, line in enumerate(f, 1):
                attrs = [float(x) for x in
                         line.replace(" ", "").strip().split(",")]
                u, v = edge_line[i]
                edge_labels[node_graph[u]][(u, v)] = attrs
                if is_symmetric:
                    edge_labels[node_graph[v]][(v, u)] = attrs
    elif meta.get("el", os.path.exists(p("edge_labels"))):
        with open(p("edge_labels")) as f:
            for i, line in enumerate(f, 1):
                lab = int(line.strip())
                u, v = edge_line[i]
                edge_labels[node_graph[u]][(u, v)] = lab
                if is_symmetric:
                    edge_labels[node_graph[v]][(v, u)] = lab

    Gs = []
    for gid in graphs:
        item = (graphs[gid], node_labels[gid], edge_labels[gid])
        Gs.append(Graph(*item) if as_graphs else list(item))

    if with_classes:
        classes = []
        with open(p("graph_labels")) as f:
            for line in f:
                classes.append(int(line.strip()))
        return Bunch(data=Gs, target=np.array(classes, dtype=int))
    return Bunch(data=Gs)


def fetch_dataset(name, verbose=True, data_home=None, download_if_missing=True,
                  with_classes=True, produce_labels_nodes=False,
                  prefer_attr_nodes=False, prefer_attr_edges=False,
                  as_graphs=False):
    """Fetch (download+cache) a TU dataset and parse it.

    reference: grakel/datasets/base.py:335-455.  In offline environments
    place the unzipped ``<name>/`` folder inside ``data_home``
    (default ``~/grakel_torch_data``).
    """
    data_home = data_home or os.path.join(
        os.path.expanduser("~"), "grakel_torch_data")
    os.makedirs(data_home, exist_ok=True)
    target_dir = os.path.join(data_home, name)
    if not os.path.isdir(target_dir):
        if not download_if_missing:
            raise IOError("dataset %s not found in %s" % (name, data_home))
        url = _BASE_URL + name + ".zip"
        zpath = os.path.join(data_home, name + ".zip")
        if verbose:
            print("Downloading", url)
        import urllib.request
        try:
            urllib.request.urlretrieve(url, zpath)
        except Exception as e:
            raise IOError(
                "could not download %s (%s); in offline environments place "
                "the unzipped dataset folder at %s" % (url, e, target_dir))
        with zipfile.ZipFile(zpath) as z:
            z.extractall(data_home)
        os.remove(zpath)
    return read_data(
        name, path=data_home, with_classes=with_classes,
        produce_labels_nodes=produce_labels_nodes,
        prefer_attr_nodes=prefer_attr_nodes,
        prefer_attr_edges=prefer_attr_edges, as_graphs=as_graphs)
