"""The port of ``visualizations/``: the kNN-k analysis
(``knn_experiments``), the geodesic explorer (``interactive_knn_viz``) and
their shared plot style (``plot_utils``). Each has a ``run`` that returns
its numbers and a ``main`` that draws them (matplotlib, imported there)."""
