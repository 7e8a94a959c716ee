"""The benchmark's yardstick: the modelled work of the kernels and of a
whole fit, the card's published peaks, and the map from the kernels'
``__global__`` names to their work."""
