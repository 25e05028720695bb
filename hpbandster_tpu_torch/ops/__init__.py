"""Device operations of the port: bracket arithmetic, KDE math, the CUDA
acquisition scorer, the rung ladder and the whole-sweep builder."""
