// ray_tpu_torch dashboard app. Hand-written vanilla JS over the /api/* REST
// surface (reference counterpart: dashboard/client/src React app). Views:
// overview tiles + resource meters, filterable entity tables, a chrome-trace
// timeline renderer, a collapsed-stack flamegraph viewer, and a job log tail.
"use strict";

const TABS = ["nodes", "actors", "tasks", "objects", "placement_groups",
              "jobs", "timeline", "flamegraph", "metrics", "worker_stacks"];
let tab = "nodes";
let filterState = "";   // state filter for tasks/actors
let filterText = "";    // substring filter
let logJob = null;      // selected job for the log tail
let flameData = null;   // last fetched profile
let profileBusy = false;

const esc = s => String(s).replace(/[&<>]/g, c => ({"&":"&amp;","<":"&lt;",">":"&gt;"}[c]));
const fmt = v => v === undefined || v === null ? "<span class=muted>—</span>" :
  typeof v === "object" ? "<code>" + esc(JSON.stringify(v)) + "</code>" : esc(v);
async function j(u) { const r = await fetch(u); if (!r.ok) throw new Error(u + ": " + r.status); return r.json(); }

const STATE_COLOR = {ALIVE:"var(--good)", RUNNING:"var(--accent)", PENDING:"var(--warn)",
  RESTARTING:"var(--warn)", DEAD:"var(--bad)", FAILED:"var(--bad)", FINISHED:"var(--ink2)",
  WAITING_DEPS:"var(--warn)", ASSIGNED:"var(--accent)", SUCCEEDED:"var(--good)"};
const stateCell = s => `<span class=st><i style="background:${STATE_COLOR[s]||"var(--ink2)"}"></i>${esc(s)}</span>`;

function applyFilters(rows, stateCol) {
  let out = rows;
  if (filterState && stateCol) out = out.filter(r => r[stateCol] === filterState);
  if (filterText) {
    const q = filterText.toLowerCase();
    out = out.filter(r => JSON.stringify(r).toLowerCase().includes(q));
  }
  return out;
}

function table(rows, cols, stateCol) {
  if (!rows || !rows.length) return "<p class=muted>none</p>";
  const shown = applyFilters(rows, stateCol);
  let h = "<table><tr>" + cols.map(c => `<th>${esc(c)}</th>`).join("") + "</tr>";
  for (const r of shown.slice(0, 500))
    h += "<tr>" + cols.map(c => `<td>${c === stateCol ? stateCell(r[c]) : fmt(r[c])}</td>`).join("") + "</tr>";
  h += "</table>";
  if (shown.length > 500) h += `<p class=muted>…and ${shown.length - 500} more</p>`;
  if (shown.length !== rows.length) h += `<p class=muted>${shown.length} of ${rows.length} shown (filtered)</p>`;
  return h;
}

function meters(res) {
  const tot = res.total || {}, avail = res.available || {};
  return Object.keys(tot).filter(k => k !== "memory").sort().map(k => {
    const t = tot[k], u = t - (avail[k] ?? t), pct = t ? Math.round(100 * u / t) : 0;
    return `<div class=meter><span class=lbl><span>${esc(k)}</span><span>${+u.toFixed(2)} / ${+t.toFixed(2)} used</span></span>
      <span class=bar><i style="width:${pct}%"></i></span></div>`;
  }).join("");
}

const tile = (k, v) => `<div class=tile><div class=v>${v}</div><div class=k>${esc(k)}</div></div>`;

// ---------------------------------------------------------------- toolbar
function toolbar() {
  if (tab === "tasks" || tab === "actors") {
    const states = tab === "tasks"
      ? ["", "PENDING", "WAITING_DEPS", "ASSIGNED", "RUNNING", "FINISHED", "FAILED"]
      : ["", "PENDING", "ALIVE", "RESTARTING", "DEAD"];
    return `<select id=fstate onchange="filterState=this.value;render()">` +
      states.map(s => `<option value="${s}" ${s === filterState ? "selected" : ""}>${s || "all states"}</option>`).join("") +
      `</select><input id=ftext placeholder="filter…" value="${esc(filterText)}"
        oninput="filterText=this.value;renderView()">`;
  }
  if (tab === "flamegraph")
    return `<button onclick="profileNow()" ${profileBusy ? "disabled" : ""}>
      ${profileBusy ? "profiling…" : "profile workers (2s)"}</button>
      <span class=sub>sampling CPU profile of every live worker</span>`;
  if (tab === "timeline")
    return `<span class=sub>task spans from the event feed; also exportable:
      <code>python -m ray_tpu_torch.obs timeline</code> → chrome://tracing</span>`;
  return "";
}

// --------------------------------------------------------------- timeline
function renderTimeline(events) {
  if (!events.length) return "<p class=muted>no finished task spans yet</p>";
  const t0 = Math.min(...events.map(e => e.ts));
  const t1 = Math.max(...events.map(e => e.ts + e.dur));
  const span = Math.max(t1 - t0, 1);
  const lanes = [...new Set(events.map(e => e.tid))];
  const laneOf = Object.fromEntries(lanes.map((l, i) => [l, i]));
  const W = 1100, ROW = 18, H = Math.min(lanes.length, 60) * ROW + 30;
  const cnv = document.createElement("canvas");
  cnv.width = W * devicePixelRatio; cnv.height = H * devicePixelRatio;
  cnv.style.height = H + "px";
  const ctx = cnv.getContext("2d");
  ctx.scale(devicePixelRatio, devicePixelRatio);
  const css = getComputedStyle(document.body);
  const colors = {task: css.getPropertyValue("--accent"), actor_method: css.getPropertyValue("--good"),
                  actor_create: css.getPropertyValue("--warn")};
  for (const e of events) {
    const lane = laneOf[e.tid]; if (lane >= 60) continue;
    const x = 40 + (e.ts - t0) / span * (W - 50);
    const w = Math.max(e.dur / span * (W - 50), 1.5);
    ctx.fillStyle = (colors[e.cat] || css.getPropertyValue("--ink2")).trim();
    ctx.fillRect(x, 24 + lane * ROW, w, ROW - 4);
  }
  ctx.fillStyle = css.getPropertyValue("--ink2").trim();
  ctx.font = "11px system-ui";
  ctx.fillText(`${events.length} spans · ${(span / 1e6).toFixed(2)}s window · one row per task chain` +
    (lanes.length > 60 ? ` · first 60/${lanes.length} rows` : ""), 40, 14);
  const wrap = document.createElement("div"); wrap.id = "timeline"; wrap.appendChild(cnv);
  return wrap;
}

// -------------------------------------------------------------- flamegraph
// Input: collapsed stack lines "frameA;frameB;frameC <count>" merged over
// all workers; output: an SVG flame graph (depth-stacked, width ∝ samples).
function buildFlame(collapsedTexts) {
  const root = {name: "all", value: 0, children: new Map()};
  for (const text of collapsedTexts) {
    for (const line of text.split("\n")) {
      const sp = line.lastIndexOf(" ");
      if (sp <= 0) continue;
      const count = parseInt(line.slice(sp + 1), 10);
      if (!count) continue;
      const frames = line.slice(0, sp).split(";");
      let node = root; root.value += count;
      for (const f of frames) {
        if (!node.children.has(f)) node.children.set(f, {name: f, value: 0, children: new Map()});
        node = node.children.get(f);
        node.value += count;
      }
    }
  }
  return root;
}

function flameSVG(root) {
  if (!root.value) return "<p class=muted>no samples (workers idle?)</p>";
  const W = 1100, ROW = 17;
  const palette = ["#e05c5c", "#e08f4f", "#e0c24f", "#9fc45c", "#5cb8a6", "#5c95d6", "#9a7fd6"];
  let maxDepth = 0, rects = [];
  (function walk(node, x, depth, w) {
    maxDepth = Math.max(maxDepth, depth);
    if (w < 1) return;
    if (depth > 0) {
      const color = palette[(node.name.length + depth) % palette.length];
      const label = w > 40 ? esc(node.name.slice(0, Math.floor(w / 6.2))) : "";
      rects.push(`<g><rect x="${x.toFixed(1)}" y="${depth * ROW}" width="${w.toFixed(1)}" height="${ROW - 1}" fill="${color}">
        <title>${esc(node.name)} — ${node.value} samples (${(100 * node.value / root.value).toFixed(1)}%)</title></rect>
        <text x="${(x + 3).toFixed(1)}" y="${depth * ROW + 12}">${label}</text></g>`);
    }
    let cx = x;
    const kids = [...node.children.values()].sort((a, b) => b.value - a.value);
    for (const k of kids) {
      const kw = w * k.value / node.value;
      walk(k, cx, depth + 1, kw);
      cx += kw;
    }
  })(root, 0, 0, W);
  const H = (maxDepth + 1) * ROW;
  return `<div id=flame><svg viewBox="0 0 ${W} ${H}" height="${H}">${rects.join("")}</svg>
    <p class=sub>${root.value} samples · width ∝ CPU time · hover for frame detail</p></div>`;
}

async function profileNow() {
  profileBusy = true; render();
  try { flameData = await j("/api/profile?seconds=2"); }
  catch (e) { flameData = {error: String(e)}; }
  profileBusy = false; render();
}

// -------------------------------------------------------------------- logs
async function logsView() {
  let jobs = [];
  try { jobs = await j("/api/jobs"); } catch (e) { /* job API optional */ }
  let h = table(jobs, ["job_id", "status", "entrypoint"], "status");
  if (jobs.length) {
    if (logJob === null) logJob = jobs[0].job_id;
    h += `<p><select onchange="logJob=this.value;render()">` +
      jobs.map(x => `<option value="${esc(x.job_id)}" ${x.job_id === logJob ? "selected" : ""}>${esc(x.job_id)}</option>`).join("") +
      `</select> <span class=sub>log tail (auto-refreshes)</span></p>`;
    try {
      const lg = await j("/api/logs?job_id=" + encodeURIComponent(logJob));
      h += `<pre class=loglines>${esc(lg.logs || "(empty)")}</pre>`;
    } catch (e) { h += `<p class=muted>${esc(e)}</p>`; }
  } else {
    h += "<p class=muted>no jobs submitted — job logs appear here " +
         "(<code>ray_tpu_torch.job.submit_job(...)</code>)</p>";
  }
  return h;
}

// -------------------------------------------------------------------- main
async function view(t, pre) {
  if (t === "nodes") return table(pre.nodes, ["NodeID", "Alive", "Resources", "Available", "Labels"], "");
  if (t === "actors") return table(pre.actors, ["actor_id", "class_name", "name", "state", "node_id"], "state");
  if (t === "tasks") return table(await j("/api/tasks"), ["task_id", "name", "state", "kind", "node_id"], "state");
  if (t === "objects") return table(await j("/api/objects"), ["object_id", "size", "where", "refcount", "pins"], "");
  if (t === "placement_groups") return table(await j("/api/placement_groups"), ["pg_id", "state", "strategy", "bundles"], "state");
  if (t === "jobs") return logsView();
  if (t === "timeline") return renderTimeline(await j("/api/timeline"));
  if (t === "flamegraph") {
    if (!flameData) return "<p class=muted>press “profile workers” to sample</p>";
    if (flameData.error) return `<p class=muted>${esc(flameData.error)}</p>`;
    const texts = [];
    for (const per of Object.values(flameData)) for (const txt of Object.values(per)) texts.push(txt);
    return flameSVG(buildFlame(texts));
  }
  if (t === "metrics") return "<pre>" + esc(JSON.stringify(await j("/api/metrics"), null, 1)) + "</pre>" +
    '<p class=muted>prometheus text at <a href="/metrics">/metrics</a> · grafana board: <a href="/api/grafana">/api/grafana</a> (<code>ray_tpu_torch.util.grafana</code>)</p>';
  if (t === "worker_stacks") {
    const s = await j("/api/worker_stacks");
    return Object.entries(s).map(([node, per]) => Object.entries(per).map(([pid, txt]) =>
      `<h3 class=muted style="font-size:.85rem">node ${esc(node).slice(0, 8)} · pid ${esc(pid)}</h3><pre>${esc(txt)}</pre>`
    ).join("")).join("") || "<p class=muted>none</p>";
  }
  return "";
}

async function renderView() {
  // re-render only #view (keeps toolbar inputs focused while typing)
  try {
    const [nodes, actors] = await Promise.all([j("/api/nodes"), j("/api/actors")]);
    const v = await view(tab, {nodes, actors});
    const el = document.getElementById("view");
    if (typeof v === "string") el.innerHTML = v;
    else { el.innerHTML = ""; el.appendChild(v); }
  } catch (e) {
    document.getElementById("view").innerHTML = "<p class=muted>" + esc(e) + "</p>";
  }
}

async function render() {
  try {
    const [res, nodes, actors, summary] = await Promise.all([
      j("/api/cluster_resources"), j("/api/nodes"), j("/api/actors"), j("/api/summary")]);
    const tasks = (summary && summary.tasks && summary.tasks.by_state) || (summary && summary.tasks) || {};
    document.getElementById("meta").textContent = new Date().toLocaleTimeString();
    document.getElementById("tiles").innerHTML =
      tile("nodes", nodes.filter(n => (n.Alive ?? n.alive) !== false).length) +
      tile("actors", actors.length) +
      tile("running tasks", tasks.RUNNING || 0) +
      tile("pending tasks", (tasks.PENDING || 0) + (tasks.WAITING_DEPS || 0)) +
      tile("objects", (summary && summary.objects && summary.objects.total) ?? "—");
    document.getElementById("meters").innerHTML = meters(res);
    document.getElementById("taskcounts").innerHTML = Object.entries(tasks)
      .map(([s, n]) => `<span>${stateCell(s)} ${n}</span>`).join("");
    document.getElementById("toolbar").innerHTML = toolbar();
    const v = await view(tab, {nodes, actors});
    const el = document.getElementById("view");
    if (typeof v === "string") el.innerHTML = v;
    else { el.innerHTML = ""; el.appendChild(v); }
  } catch (e) {
    document.getElementById("view").innerHTML = "<p class=muted>" + esc(e) + "</p>";
  }
}

document.getElementById("tabs").innerHTML = TABS.map(t =>
  `<button id="tab-${t}" onclick="tab='${t}';syncTabs();render()">${t.replace(/_/g, " ")}</button>`).join("");
function syncTabs() { for (const t of TABS) document.getElementById("tab-" + t).className = t === tab ? "on" : ""; }
syncTabs(); render();
setInterval(() => {
  if (document.getElementById("auto").checked && tab !== "flamegraph") render();
}, 3000);
