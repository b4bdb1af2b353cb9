"""Static sequencer dashboard served at GET /app.

Role parity: the reference serves a Vite/React dashboard at /app
(api/api.go:29-32, webapp/).  This build ships a dependency-free
single-file page that polls the node's own JSON API (/info, /processes,
/sequencer/workers, /sequencer/stats/{pid}) — same observability surface,
no build toolchain.
"""

DASHBOARD_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>davinci-tpu sequencer</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 14px/1.5 system-ui, sans-serif; margin: 2rem auto;
         max-width: 960px; padding: 0 1rem; }
  h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 2rem; }
  table { border-collapse: collapse; width: 100%; }
  th, td { text-align: left; padding: .35rem .6rem;
           border-bottom: 1px solid rgba(127,127,127,.35); }
  th { font-weight: 600; }
  .muted { opacity: .65; }
  .pill { display: inline-block; padding: 0 .5rem; border-radius: 999px;
          border: 1px solid rgba(127,127,127,.5); font-size: .85em; }
</style>
</head>
<body>
<h1>davinci-tpu sequencer <span id="name" class="pill"></span></h1>
<p class="muted">Auto-refreshes every 5 s. JSON API lives at
<code>/info</code>, <code>/processes</code>, <code>/sequencer/stats/{pid}</code>,
<code>/sequencer/workers</code>.</p>

<h2>Queues</h2>
<table id="queues"><thead><tr><th>queue</th><th>depth</th></tr></thead>
<tbody></tbody></table>

<h2>Processes</h2>
<table id="procs"><thead><tr>
<th>process</th><th>state root</th><th>verified</th><th>aggregated</th>
<th>transitions</th><th>settled</th></tr></thead><tbody></tbody></table>

<h2>Workers</h2>
<table id="workers"><thead><tr>
<th>worker</th><th>success</th><th>failures</th><th>banned</th>
</tr></thead><tbody></tbody></table>

<script>
async function j(p) {
  try { const r = await fetch(p); return r.ok ? r.json() : null; }
  catch (e) { return null; }
}
function row(cells) {
  const tr = document.createElement("tr");
  for (const c of cells) {
    const td = document.createElement("td");
    td.textContent = c === undefined || c === null ? "—" : String(c);
    tr.appendChild(td);
  }
  return tr;
}
function fill(id, rows) {
  const tb = document.querySelector(`#${id} tbody`);
  tb.replaceChildren(...rows);
}
async function refresh() {
  const info = await j("/info");
  if (info) {
    document.getElementById("name").textContent = info.name || "";
    fill("queues", Object.entries(info.queues || {}).map(
      ([q, d]) => row([q, d])));
  }
  const procs = await j("/processes");
  if (procs && procs.processes) {
    const rows = [];
    for (const pid of procs.processes) {
      const p = await j(`/processes/${pid}`) || {};
      const s = await j(`/sequencer/stats/${pid}`) || {};
      rows.push(row([pid, (p.stateRoot || "").slice(0, 18),
        s.verified_votes, s.aggregated_votes,
        s.state_transitions, s.settled_transitions]));
    }
    fill("procs", rows);
  }
  const w = await j("/sequencer/workers");
  if (w && w.workers) {
    fill("workers", Object.entries(w.workers).map(([name, x]) =>
      row([name, x.success, x.failures, x.banned ? "banned" : ""])));
  }
}
refresh();
setInterval(refresh, 5000);
</script>
</body>
</html>
"""
