"""One module a model family, found by a configuration's ``model_type``
(``bench.model.family``).  See ``bench/README.md`` for what a family
module supplies."""
