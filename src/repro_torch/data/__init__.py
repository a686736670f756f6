"""Synthetic retrieval data (the retrieval half of the reference's
pipeline)."""
from .pipeline import RetrievalDataset, make_retrieval_dataset
