"""Text substrate: synthetic corpora (numpy), tf-idf weighting and corpus
preparation onto a device."""
