from . import tree, frep, shapes
