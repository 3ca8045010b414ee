from .ollama import OllamaClient  # noqa: F401
from .chatbot import RAGChatbot  # noqa: F401
from .application import RAGApplication  # noqa: F401
