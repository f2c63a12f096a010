"""PiDRAM core for the port: one :class:`PimLib` protocol (copy, init,
bitwise, rand, read, write, flush, with a unified :class:`OpReceipt`)
over two faces, backed by the opcode-keyed op registry
(:mod:`repro_torch.core.op_registry`) and the batched PiM op queue
(:mod:`repro_torch.core.pim_queue`).  The counterparts of the JAX
package's ``core`` modules of the same names.

The model face (the simulated DDR3 prototype; numpy only, copies of the
JAX package's modules, every latency the prototype's):
  timing, dram_model, memctrl, subarray, allocator, coherence, isa, poc,
  drange, pimolib.DeviceLib

The torch face (the port's kernels on the card):
  pimolib.TorchLib / TorchArena over repro_torch.kernels.*
"""

from .allocator import (Allocation, CoherenceState, PimAllocError,
                        SubarrayAllocator, allocator_from_subarray_map,
                        arena_groups)
from .coherence import CoherenceModel, CoherencePolicy
from .dram_model import CellPhysics, DRAMGeometry, SimulatedDRAM
from .drange import DRangeTRNG, characterize
from .isa import Instruction, Opcode
from .memctrl import EndToEndCosts, MemoryController
from .op_registry import (FACE_DEVICE, FACE_TORCH, KVWriteBatch, PimOpSpec,
                          get_op, ops_for_face, register_pim_op,
                          unregister_pim_op)
from .pim_queue import PimOpQueue
from .pimolib import (Blocking, DeviceLib, OpReceipt, PimLib, TorchArena,
                      TorchLib, make_torch_arena)
from .poc import PimOpsController
from .subarray import SubarrayMap, discover_subarrays
from .timing import (DDR3Timings, PrototypeParams, ViolatedTimings,
                     DEFAULT_PROTOTYPE, DEFAULT_TIMINGS, DEFAULT_VIOLATIONS)
