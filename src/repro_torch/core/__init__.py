"""PiDRAM core for the port: the subarray-aware allocator, the deferred
PiM op queue with its flush executors, and the pimolib face over torch
arenas (counterparts of the JAX package's ``core`` modules of the same
names; the model face and its DDR3 timing model are a later slice)."""
