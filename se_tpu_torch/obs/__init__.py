from .progress import Bar
from .writer import Writer
