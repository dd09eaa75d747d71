from qtpu_torch.eval.perplexity import evaluate_perplexity  # noqa: F401
