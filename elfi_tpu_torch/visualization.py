"""Plotting utilities (counterpart of :mod:`elfi_tpu.visualization`).

Matplotlib, graphviz and IPython are imported inside the functions that
draw, never when this module is imported: ``import elfi_tpu_torch`` works
where none of them is installed, as on a machine that only computes.
Values that live on the card are copied off it before they are drawn.
"""

from __future__ import annotations

import numpy as np

from .utils import to_numpy

__all__ = ["plot_marginals", "plot_pairs", "plot_traces", "plot_sample",
           "plot_discrepancy", "plot_gp", "plot_params_vs_node",
           "plot_predicted_summaries", "draw_contour", "ProgressBar",
           "nx_draw", "draw"]


def _mpl():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _np(x):
    """``x`` as a numpy array, copied off the card if it is a tensor."""
    return np.asarray(to_numpy(x))


def _limit_params(samples, selector=None):
    """Pick a subset of parameters by index or name."""
    if selector is None:
        return dict(samples)
    out = {}
    for i, (k, v) in enumerate(samples.items()):
        if i in selector or k in selector:
            out[k] = v
    return out


def plot_marginals(samples, selector=None, bins=20, axes=None, **kwargs):
    """Histogram of each parameter's marginal."""
    plt = _mpl()
    samples = _limit_params(samples, selector)
    n = len(samples)
    if axes is None:
        fig, axes = plt.subplots(1, n, figsize=(4 * n, 3), squeeze=False)
        axes = axes[0]
    axes = np.atleast_1d(axes)
    for ax, (name, vals) in zip(axes, samples.items()):
        ax.hist(_np(vals).ravel(), bins=bins, **kwargs)
        ax.set_xlabel(name)
    return axes


def plot_pairs(samples, selector=None, bins=20, axes=None, **kwargs):
    """Pairwise scatter + marginal histograms."""
    plt = _mpl()
    samples = _limit_params(samples, selector)
    names = list(samples)
    n = len(names)
    if axes is None:
        fig, axes = plt.subplots(n, n, figsize=(3 * n, 3 * n), squeeze=False)
    axes = np.atleast_2d(axes)
    for i, ni in enumerate(names):
        for j, nj in enumerate(names):
            ax = axes[i][j]
            if i == j:
                ax.hist(_np(samples[ni]).ravel(), bins=bins, **kwargs)
            else:
                ax.scatter(_np(samples[nj]).ravel(),
                           _np(samples[ni]).ravel(), s=2, **kwargs)
            if i == n - 1:
                ax.set_xlabel(nj)
            if j == 0:
                ax.set_ylabel(ni)
    return axes


def plot_traces(result, selector=None, axes=None, **kwargs):
    """MCMC trace plots per chain and parameter."""
    plt = _mpl()
    chains = _np(result.chains)
    n_chains, _, dim = chains.shape
    names = list(result.parameter_names)
    if axes is None:
        fig, axes = plt.subplots(dim, 1, figsize=(8, 2 * dim), squeeze=False)
        axes = axes[:, 0]
    axes = np.atleast_1d(axes)
    for d, ax in enumerate(axes[:dim]):
        for c in range(n_chains):
            ax.plot(chains[c, :, d], lw=0.5, **kwargs)
        ax.axvline(result.warmup, color="k", ls="--", lw=0.5)
        ax.set_ylabel(names[d])
    return axes


def _prepare_axes(options):
    """Axes from options (or current); cleared + limited for live mode."""
    plt = _mpl()
    axes = options.get("axes") or plt.gca()
    if options.get("interactive"):
        axes.clear()
    if options.get("xlim"):
        axes.set_xlim(options["xlim"])
    if options.get("ylim"):
        axes.set_ylim(options["ylim"])
    return axes


def _update_interactive(displays, options):
    """Redraw in-notebook: clear the cell output and re-display the figure;
    outside IPython a short ``plt.pause``."""
    if not options.get("interactive"):
        return
    plt = _mpl()
    try:
        from IPython import display
    except ImportError:
        plt.pause(1e-6)   # plain-matplotlib fallback for live scripts
        return
    displays = list(displays or [])
    display.clear_output(wait=True)
    displays.insert(0, plt.gcf())
    display.display(*displays)


def plot_sample(samples, nodes=None, n=-1, displays=None, **options):
    """Scatter of (possibly top-n) samples; with ``interactive=True`` the
    plot live-updates in notebooks during inference."""
    plt = _mpl()
    axes = _prepare_axes(options)
    nodes = nodes or sorted(samples.keys())[:2]
    if isinstance(nodes, str):
        nodes = [nodes]
    if len(nodes) == 1:
        axes.hist(_np(samples[nodes[0]])[:n])
        axes.set_xlabel(nodes[0])
    else:
        axes.scatter(_np(samples[nodes[0]])[:n],
                     _np(samples[nodes[1]])[:n], s=2)
        axes.set_xlabel(nodes[0])
        axes.set_ylabel(nodes[1])
    _update_interactive(displays, options)
    if options.get("close"):
        plt.close()


def plot_discrepancy(gp, parameter_names, axes=None, **kwargs):
    """Acquired discrepancy values vs each parameter."""
    plt = _mpl()
    x, y = _np(gp.x), _np(gp.y).ravel()
    dim = x.shape[1]
    if axes is None:
        fig, axes = plt.subplots(1, dim, figsize=(4 * dim, 3), squeeze=False)
        axes = axes[0]
    axes = np.atleast_1d(axes)
    for d, ax in enumerate(axes[:dim]):
        ax.scatter(x[:, d], y, s=4)
        ax.set_xlabel(parameter_names[d])
        ax.set_ylabel("discrepancy")
    return axes


def plot_gp(gp, parameter_names, axes=None, resol=50, const=None, bounds=None,
            true_params=None, **kwargs):
    """Pairwise GP posterior-mean contours."""
    plt = _mpl()
    dim = len(parameter_names)
    bounds = bounds or gp.bounds
    const = const if const is not None else _np(gp.x)[
        np.argmin(_np(gp.y).ravel())]
    fig, axes = plt.subplots(dim, dim, figsize=(3 * dim, 3 * dim),
                             squeeze=False)
    for i in range(dim):
        for j in range(dim):
            ax = axes[i][j]
            if i == j:
                xs = np.linspace(*bounds[i], resol)
                grid = np.tile(const, (resol, 1))
                grid[:, i] = xs
                mu, _ = gp.predict(grid)
                ax.plot(xs, _np(mu).ravel())
                ax.set_xlabel(parameter_names[i])
            else:
                xs = np.linspace(*bounds[j], resol)
                ys = np.linspace(*bounds[i], resol)
                XX, YY = np.meshgrid(xs, ys)
                grid = np.tile(const, (resol * resol, 1))
                grid[:, j] = XX.ravel()
                grid[:, i] = YY.ravel()
                mu, _ = gp.predict(grid)
                ax.contourf(XX, YY, _np(mu).reshape(resol, resol))
                if true_params is not None:
                    ax.plot(true_params[parameter_names[j]],
                            true_params[parameter_names[i]], "rx")
    return axes


def nx_draw(model, internal=False, filename=None, format=None):
    """Draw the model DAG with graphviz if available, else matplotlib."""
    dag = model.dag if hasattr(model, "dag") else model.model.dag
    try:
        import graphviz
        g = graphviz.Digraph()
        for n in dag.nodes:
            if not internal and n.startswith("_"):
                continue
            g.node(n, shape="box" if dag.nodes[n].get("observable")
                   else "ellipse")
        for child in dag.nodes:
            for parent in dag.parents(child):
                if not internal and (parent.startswith("_")
                                     or child.startswith("_")):
                    continue
                g.edge(parent, child)
        if filename:
            g.render(filename, format=format or "png")
        return g
    except ImportError:
        plt = _mpl()
        names = [n for n in dag.nodes if internal or not n.startswith("_")]
        pos = {n: (i, -len(dag.ancestors([n]))) for i, n in enumerate(names)}
        for child in names:
            for parent in dag.parents(child):
                if parent in pos:
                    plt.plot([pos[parent][0], pos[child][0]],
                             [pos[parent][1], pos[child][1]], "k-", lw=0.5)
        for n, (x, y) in pos.items():
            plt.text(x, y, n, ha="center",
                     bbox=dict(boxstyle="round", fc="w"))
        plt.axis("off")
        return None


draw = nx_draw


def plot_params_vs_node(node, n_samples=100, func=None, seed=None, axes=None,
                        **kwargs):
    """Scatter model parameters against a (scalar-output) node -- e.g. how a
    summary varies with the parameters.  ``Model.generate`` runs on the
    global backend's device and returns numpy."""
    plt = _mpl()
    model = node.model
    parameters = model.parameter_names
    if node.name in parameters:
        out = model.generate(n_samples, outputs=[node.name], seed=seed)
        fig, ax = plt.subplots()
        ax.hist(_np(out[node.name]).ravel(), **kwargs)
        ax.set_xlabel(node.name)
        return np.array([ax])
    outputs = model.generate(n_samples, outputs=parameters + [node.name],
                             seed=seed)
    vals = _np(outputs[node.name])
    if func is not None:
        vals = _np(func(vals))
    vals = vals.reshape(n_samples, -1)[:, 0]
    if axes is None:
        fig, axes = plt.subplots(1, len(parameters),
                                 figsize=(4 * len(parameters), 3),
                                 squeeze=False)
        axes = axes[0]
    axes = np.atleast_1d(axes)
    for ax, p in zip(axes, parameters):
        ax.scatter(_np(outputs[p]).ravel(), vals, s=4, **kwargs)
        ax.set_xlabel(p)
        ax.set_ylabel(node.name)
    return axes


def plot_predicted_summaries(model=None, summary_names=None, n_samples=100,
                             seed=None, bins=20, axes=None,
                             add_observed=True, **kwargs):
    """Pairplots of summaries under the prior predictive, with the observed
    summary point marked."""
    _mpl()
    from .compile.compiler import compile_program
    from .parallel.backends import resolve_device
    outputs = model.generate(n_samples, outputs=list(summary_names),
                             seed=seed)
    samples = {s: _np(outputs[s]).reshape(n_samples, -1)[:, 0]
               for s in summary_names}
    axes = plot_pairs(samples, bins=bins, axes=axes, **kwargs)
    if add_observed:
        prog = compile_program(model, tuple(summary_names),
                               device=resolve_device(None))
        obs = {s: float(_np(prog.observed_value(s)).ravel()[0])
               for s in summary_names}
        names = list(samples)
        for i, ni in enumerate(names):
            for j, nj in enumerate(names):
                if i != j:
                    axes[i][j].plot(obs[nj], obs[ni], "r*", markersize=12)
    return axes


def draw_contour(fn, bounds, parameter_names=None, title=None, points=None,
                 axes=None, resol=50, displays=None, **options):
    """Contour plot of a 2-D function over bounds; supports the same
    ``interactive``/``close`` live-update options as :func:`plot_sample`."""
    plt = _mpl()
    if axes is None:
        axes = _prepare_axes(options)
    x = np.linspace(*bounds[0], resol)
    y = np.linspace(*bounds[1], resol)
    X, Y = np.meshgrid(x, y)
    grid = np.stack([X.ravel(), Y.ravel()], axis=1)
    Z = _np(fn(grid)).reshape(resol, resol)
    axes.contourf(X, Y, Z, 30)
    if points is not None:
        points = _np(points)
        axes.scatter(points[:-1, 0], points[:-1, 1], c="k", s=6)
        # highlight the newest acquisition in live mode
        axes.scatter(points[-1:, 0], points[-1:, 1], c="r", s=12)
    if title:
        axes.set_title(title)
    if parameter_names is not None:
        axes.set_xlabel(parameter_names[0])
        axes.set_ylabel(parameter_names[1])
    _update_interactive(displays, options)
    if options.get("close"):
        plt.close()
    return axes


class ProgressBar:
    """Textual progress bar."""

    def __init__(self, prefix="Progress", suffix="Complete", decimals=1,
                 length=50, fill="="):
        self.prefix = prefix
        self.suffix = suffix
        self.decimals = decimals
        self.length = length
        self.fill = fill
        self.scaling = 0
        self.finished = False

    def reinit_progressbar(self, scaling=0, reinit_msg=""):
        self.scaling = scaling
        self.finished = False
        if reinit_msg:
            print(f"\n{reinit_msg}")

    def update_progressbar(self, iteration, total):
        total = max(total, 1)
        frac = min(iteration / total, 1.0)
        pct = f"{100 * frac:.{self.decimals}f}"
        filled = int(self.length * frac)
        bar = self.fill * filled + "-" * (self.length - filled)
        print(f"\r{self.prefix} [{bar}] {pct}% {self.suffix}", end="",
              flush=True)
        if frac >= 1.0 and not self.finished:
            print()
            self.finished = True
