"""Sharded rendering over `torch.distributed` (counterpart of
`raytracing_gpu_tpu/parallel/`).  A rank takes the place of a JAX device:
`mesh` lays the ranks out as an (sp, dp) grid, `distributed` joins a
process group, `render` splits a chunk's samples (sp) and pixel spans (dp)
over the mesh, and `dryrun` spawns a world of ranks with a deadline."""
