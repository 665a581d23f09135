"""Model zoo: the six reference models, batched on device
(/root/reference/amico/models.pyx:221,375,656,995,1290,1344).

Plugin hook parity: extra model classes can be injected via the
``AMICO_WIP_MODELS`` environment variable pointing at a directory containing
``amicowipmodels.py`` (reference models.pyx:20-26).
"""
import os
import sys

from .base import BaseModel
from .cylinder_zeppelin_ball import CylinderZeppelinBall
from .free_water import FreeWater
from .noddi import NODDI
from .sandi import SANDI
from .stick_zeppelin_ball import StickZeppelinBall
from .volume_fractions import VolumeFractions

__all__ = ['BaseModel', 'CylinderZeppelinBall', 'FreeWater', 'NODDI',
           'SANDI', 'StickZeppelinBall', 'VolumeFractions']

# WIP-model plugin hook (reference models.pyx:20-26)
try:
    sys.path.append(os.environ['AMICO_WIP_MODELS'])
    from amicowipmodels import *  # noqa: F401,F403
    try:
        from amicowipmodels import __all__ as _wip_all
        __all__ = __all__ + list(_wip_all)
    except ImportError:
        pass
except KeyError:
    pass
except ImportError:
    pass
