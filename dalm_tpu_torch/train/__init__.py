from dalm_tpu_torch.train.generator_only import train_generator
from dalm_tpu_torch.train.rag_e2e import train_e2e
from dalm_tpu_torch.train.retriever_only import train_retriever

__all__ = ["train_e2e", "train_generator", "train_retriever"]
