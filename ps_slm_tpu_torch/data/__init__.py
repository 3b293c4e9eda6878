"""Host data pipeline: manifests, audio readers, tokenizers, batching."""
