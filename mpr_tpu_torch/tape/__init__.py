from .opcodes import Op, op_str
from .tape import Tape, compile_tree, TapeError
