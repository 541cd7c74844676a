from . import fixed, methods, multistep, tableaux
from .methods import ADAPTIVE_METHODS, REGISTRY, get
