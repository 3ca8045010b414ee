from .chunker import ChunkerConfig, MarkdownChunker  # noqa: F401
from .store import ChunkStore  # noqa: F401
from .pdf import document_to_markdown, extract_pdf_images  # noqa: F401
from .processor import DocumentProcessor  # noqa: F401
