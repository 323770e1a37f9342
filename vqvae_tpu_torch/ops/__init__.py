from .assign import nearest_codes, nearest_codes_reference
from .ivf import knn_search_ivf
from .ell import BucketedGraph, multi_source_shortest_paths_ell
from .graph import (analyze_graph_connectivity, build_knn_graph,
                    build_knn_graph_auto, largest_connected_component,
                    symmetric_csr_from_edges)
from .kmedoids import (assign_points_to_medoids, compute_quantization_error,
                       fit_kmedoids, fit_kmedoids_with_connectivity_check,
                       kpp_initialization, kpp_parallel_initialization)
from .kmeans_euclidean import fit_kmeans
from .knn import knn_search
from .knn_select import fused_select, fused_select_reference
from .riemannian import (build_mlp_decode_fn, edge_lengths_riemannian,
                         edge_lengths_riemannian_auto,
                         edge_lengths_riemannian_indexed,
                         edge_lengths_riemannian_nodal,
                         make_decoder_image_fn, pullback_metrics)
from .connected import connected_components_device
from .shortest_paths import (EdgeList, distances_between,
                             multi_source_shortest_paths,
                             single_source_shortest_paths)
from . import geo_compat

__all__ = [
    "nearest_codes",
    "nearest_codes_reference",
    "knn_search_ivf",
    "fit_kmeans",
    "BucketedGraph",
    "multi_source_shortest_paths_ell",
    "EdgeList",
    "multi_source_shortest_paths",
    "single_source_shortest_paths",
    "distances_between",
    "connected_components_device",
    "geo_compat",
    "analyze_graph_connectivity",
    "build_knn_graph",
    "build_knn_graph_auto",
    "largest_connected_component",
    "symmetric_csr_from_edges",
    "assign_points_to_medoids",
    "compute_quantization_error",
    "fit_kmedoids",
    "fit_kmedoids_with_connectivity_check",
    "kpp_initialization",
    "kpp_parallel_initialization",
    "knn_search",
    "fused_select",
    "fused_select_reference",
    "build_mlp_decode_fn",
    "edge_lengths_riemannian",
    "edge_lengths_riemannian_auto",
    "edge_lengths_riemannian_indexed",
    "edge_lengths_riemannian_nodal",
    "make_decoder_image_fn",
    "pullback_metrics",
]
