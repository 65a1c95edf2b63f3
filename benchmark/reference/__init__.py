"""The plain reference the benchmark holds the port to.

Plain PyTorch and NumPy, written for the benchmark from the reference
renderer's equations (`camera.h`, `aarect.h`, `box.h`, `hittable.h`,
`constant_medium.h`, `material.h`, `render.h`, `color.h`) with the port's
counter-based random stream and its order of operations, so that a sound
run of the port agrees with it path for path.  It imports nothing of the
port or of the JAX package and takes nothing the port made: it reads the
scene from the configuration file and works every table out itself.
"""
