"""PiDRAM instruction encoding.

The POC consumes 64-bit instructions written to its memory-mapped
*instruction* register.  We mirror the prototype's encoding: an opcode
field plus two operand fields (row addresses or sizes).  The encoding is
exercised end-to-end: pimolib encodes, the POC decodes, tests round-trip.

    63      56 55        28 27         0
    [ opcode ] [ operand1 ] [ operand0 ]
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class Opcode(enum.IntEnum):
    NOP = 0x00
    RC_COPY = 0x01      # RowClone-Copy:  operand0=src row, operand1=dst row
    RC_INIT = 0x02      # RowClone-Init:  operand0=zero row, operand1=dst row
    DR_GEN = 0x03       # D-RaNGe: operand0=row, operand1=n_bits
    BULK_COPY = 0x04    # multi-row copy: operands are base rows (count via imm)
    READ_BUF = 0x05     # drain random-number buffer into data register
    KV_WRITE = 0x06     # slot-granular KV scatter: array-face only (no DDR3
                        # command sequence exists for it; the model face
                        # reports it unsupported and callers fall back to
                        # the CPU write path)
    AMB_AND = 0x07      # Ambit AND: operand0=src row, operand1=dst row,
                        # dst <- src & dst (TRA, same-subarray only)
    AMB_OR = 0x08       # Ambit OR:  dst <- src | dst (TRA with C1 control row)
    AMB_NOT = 0x09      # Ambit NOT: dst <- ~src (dual-contact-cell row)
    SSM_STATE_WRITE = 0x0A  # slot-granular SSM recurrent-state scatter:
                        # array-face only, like KV_WRITE (no DDR3 sequence;
                        # the model face reports it unsupported and replay
                        # prices it as CPU traffic).  State page copy/init
                        # ride the existing RC_COPY/RC_INIT RowClone ops.


_OP_BITS = 28
_OP_MASK = (1 << _OP_BITS) - 1


@dataclass(frozen=True)
class Instruction:
    opcode: Opcode
    operand0: int = 0
    operand1: int = 0

    def encode(self) -> int:
        if not (0 <= self.operand0 <= _OP_MASK and 0 <= self.operand1 <= _OP_MASK):
            raise ValueError("operand out of range")
        return (int(self.opcode) << (2 * _OP_BITS)) | (self.operand1 << _OP_BITS) | self.operand0

    @staticmethod
    def decode(word: int) -> "Instruction":
        return Instruction(
            opcode=Opcode((word >> (2 * _OP_BITS)) & 0xFF),
            operand1=(word >> _OP_BITS) & _OP_MASK,
            operand0=word & _OP_MASK,
        )
