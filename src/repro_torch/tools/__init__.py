"""Command-line tools: the offline tune CLI, the pass-pipeline explainer and
the markdown link checker."""
