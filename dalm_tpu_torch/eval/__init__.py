"""Evaluation (counterpart of ``dalm_tpu/eval``): retrieval metrics (recall,
precision, hit rate, MRR) over an exact ``DenseIndex`` searched by K3, and
the RAG generator's exact match."""

from dalm_tpu_torch.eval.results import EvalResults

__all__ = ["EvalResults", "evaluate_retriever", "evaluate_rag"]


def __getattr__(name):
    if name == "evaluate_retriever":
        from dalm_tpu_torch.eval.retriever import evaluate_retriever

        return evaluate_retriever
    if name == "evaluate_rag":
        from dalm_tpu_torch.eval.rag import evaluate_rag

        return evaluate_rag
    raise AttributeError(name)
