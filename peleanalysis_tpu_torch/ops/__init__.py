"""Ghost fill, stencils and the gradient kernel."""
