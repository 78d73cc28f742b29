from .tape_data import TapeData
