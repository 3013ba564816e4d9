"""Box/geometry metadata and the dense device model of the AMR hierarchy."""
