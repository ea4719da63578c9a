"""Launchers of the port (`serve`, `train`), its meshes (`mesh`) and the
analytic roofline of a cell (`hbm_model`, `roofline`)."""
