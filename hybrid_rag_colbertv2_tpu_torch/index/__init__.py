from .lexical import LexicalIndex, tokenize_lexical  # noqa: F401
from .dense import DenseTokenIndex  # noqa: F401
from .manager import IndexManager  # noqa: F401
