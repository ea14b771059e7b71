from graph_tpu_torch.io.binary import BinaryInput, load_graph, save_graph
from graph_tpu_torch.io.datasets import graph500_path, load_graph500
from graph_tpu_torch.io.dotgraph import DotGraphInput
from graph_tpu_torch.io.edgelist import EdgeListInput
from graph_tpu_torch.io.graph500 import Graph500Input

__all__ = ["EdgeListInput", "Graph500Input", "BinaryInput", "DotGraphInput",
           "graph500_path", "load_graph500", "load_graph", "save_graph"]
