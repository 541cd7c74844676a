from . import eft, nbody
