"""Command-line tools: the offline tune CLI and the pass-pipeline explainer."""
