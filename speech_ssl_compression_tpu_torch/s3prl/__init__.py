from .expert import UpstreamExpert
from . import hubconf
