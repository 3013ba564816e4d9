"""Isosurface geometry: marching cubes (3-D) and marching squares (DIM=2
plotfiles) over the dense AMR levels, and their case tables."""
