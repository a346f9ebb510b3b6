from dalm_tpu_torch.train.rag_e2e import train_e2e

__all__ = ["train_e2e"]
